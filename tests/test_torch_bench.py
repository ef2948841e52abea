"""The port's bench entry point, ``python -m supervised_gan_tpu_torch.bench``,
on the CPU: its DSGAN_ARGS with the narrow 128 px flags of
tests/test_torch_train_step.py after them, one window of 2 steps, on the
kernels' route and under --no_pallas, then one window of the chunked
dispatch (chunks of 2 steps, eager on the CPU).  Checked: the record's
keys and types, finite losses, the per-step and chunked rates with the
headline the better of them, every device field null on the CPU, the gates
echoing the route, and the command line printing the record as its last
line (bench_extra's configurations: tests/test_torch_bench_extra.py)."""

import json
import sys

import pytest

from supervised_gan_tpu_torch import bench
from supervised_gan_tpu_torch.ops import kernels as K

from test_torch_train_step import FLAGS
from test_torch_layout import one_thread  # noqa: F401

ROUTES = {'kernels': [], 'no_pallas': ['--no_pallas']}
DEVICE_FIELDS = ('device_ms_per_step', 'device_kernels_per_step',
                 'busy_share', 'host_gap_ms', 'device_rate_img_s', 'device',
                 'chunked_device_ms_per_step',
                 'chunked_device_kernels_per_step', 'chunked_busy_share',
                 'graph_kernels', 'chunked_kernels_outside_graph_per_step')
RECORD_KEYS = {
    'metric', 'value', 'unit', 'dispatch_mode', 'per_step_img_s',
    'windows_img_s', 'window_steps', 'chunk_steps', 'chunked_img_s',
    'chunked_windows_img_s', 'chunked_wall_ms_per_step',
    'chunked_device_ms_per_step', 'chunked_device_kernels_per_step',
    'chunked_busy_share', 'graph_kernels',
    'chunked_kernels_outside_graph_per_step', 'finite',
    'wall_ms_per_step', 'enqueue_ms_per_step', 'device_ms_per_step',
    'device_kernels_per_step', 'busy_share', 'host_gap_ms',
    'device_rate_img_s', 'trace_steps', 'trace_primer_records_lost',
    'launches_per_step', 'warmup_s', 'backend', 'device', 'gates'}
FLOAT_FIELDS = ('value', 'per_step_img_s', 'wall_ms_per_step',
                'enqueue_ms_per_step', 'warmup_s', 'chunked_img_s',
                'chunked_wall_ms_per_step')


def _flags(ckpt, route):
    return (FLAGS + ['--checkpoints_dir', ckpt, '--gpu_ids', '-1']
            + ROUTES[route])


@pytest.fixture(scope='module', params=sorted(ROUTES))
def record(request, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp('bench'))
    try:
        rec = bench.main(_flags(ckpt, request.param), windows=1,
                         window_steps=2, trace_steps=1, chunk=2)
    finally:
        K.set_kernels_enabled(True)
    return request.param, rec


def test_record_keys_and_types(record):
    _, rec = record
    assert set(rec) == RECORD_KEYS
    assert rec['metric'] == \
        'vnc128_dsgan_twostage_cycle_train_images_per_sec_per_chip'
    assert rec['unit'] == 'images/sec'
    for k in FLOAT_FIELDS:
        assert isinstance(rec[k], float) and rec[k] > 0, k
    assert rec['per_step_img_s'] == rec['windows_img_s'][0]
    assert rec['chunked_img_s'] == rec['chunked_windows_img_s'][0]
    assert len(rec['windows_img_s']) == 1 and rec['window_steps'] == 2
    assert len(rec['chunked_windows_img_s']) == 1 and rec['chunk_steps'] == 2
    assert rec['trace_steps'] == 1
    assert abs(rec['wall_ms_per_step'] * rec['per_step_img_s'] - 1e3) < 1e-6
    assert abs(rec['chunked_wall_ms_per_step'] * rec['chunked_img_s']
               - 1e3) < 1e-6
    assert json.loads(json.dumps(rec)) == rec


def test_record_is_finite_and_per_step(record):
    """The headline is the better dispatch mode, named as the JAX bench
    names it."""
    _, rec = record
    assert rec['finite'] is True
    assert rec['chunked_img_s'] is not None
    assert rec['value'] == max(rec['per_step_img_s'], rec['chunked_img_s'])
    assert rec['dispatch_mode'] == (
        'chunked[k=2]' if rec['chunked_img_s'] > rec['per_step_img_s']
        else 'per_step')


def test_device_fields_null_on_the_cpu(record):
    _, rec = record
    assert rec['backend'] == 'cpu'
    for k in DEVICE_FIELDS + ('trace_primer_records_lost',):
        assert rec[k] is None, k
    # CPU tensors take the plain versions: no kernel launches
    assert rec['launches_per_step'] == {k.__name__: 0.0 for k in K.KERNELS}


def test_gates_echo_the_route(record):
    route, rec = record
    assert rec['gates'] == {
        'kernels': route == 'kernels', 'conv3_in_fused': False,
        'compute_dtype': 'bfloat16', 'skip_inert_bias': True,
        'tf32': {'cudnn': False, 'matmul': False}}


def test_cli_prints_the_record_last(tmp_path, monkeypatch, capsys):
    """main() reads its flags from the command line, after DSGAN_ARGS, and
    prints the record as the last line (one short window here)."""
    monkeypatch.setattr(sys, 'argv', ['bench'] + _flags(str(tmp_path),
                                                         'no_pallas'))
    try:
        bench.main(windows=1, window_steps=1, trace_steps=1, chunk=1)
    finally:
        K.set_kernels_enabled(True)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['gates']['kernels'] is False and rec['backend'] == 'cpu'
    assert rec['metric'].startswith('vnc128_')
