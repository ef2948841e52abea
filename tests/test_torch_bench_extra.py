"""``python -m supervised_gan_tpu_torch.bench_extra`` on the CPU: each of its
three configurations (tools/bench_extra.py:36-80) at narrow widths (ngf and
ndf 4; 128 px, or 256 px for unet_256), one warm-up step and windows of one
step, its record that of bench.main with its ``config`` and metric and every
device field null; and the command line printing one record a
configuration.  A file of its own, beside tests/test_torch_bench.py, so that
the two bench files run on different workers."""

import json
import sys

import pytest

from supervised_gan_tpu_torch import bench, bench_extra

from test_torch_bench import DEVICE_FIELDS, RECORD_KEYS
from test_torch_layout import one_thread  # noqa: F401


# each bench_extra configuration cut to narrow widths for the CPU: the
# fcgan G's side is noiseSize * 2^(n_layers_G + 1), so noiseSize 2 gives
# 128 px; unet_256 needs 256 px
NARROW = {
    'fcgan_unsup_512': ['--ngf', '4', '--ndf', '4', '--noiseSize', '2',
                        '--loadSize', '128', '--fineSize', '128'],
    'fcgan_joint_512': ['--ngf', '4', '--ndf', '4', '--noiseSize', '2',
                        '--loadSize', '128', '--fineSize', '128'],
    'cgan_pix2pix_512': ['--ngf', '4', '--ndf', '4', '--loadSize', '256',
                         '--fineSize', '256'],
}


@pytest.mark.parametrize("config", sorted(NARROW))
def test_bench_extra_config(config, tmp_path, monkeypatch):
    """One warm-up step and windows of one step: the record, not a rate."""
    monkeypatch.setattr(bench, 'WARMUP_STEPS', 1)
    rec = bench_extra.run(
        config, NARROW[config] + ['--gpu_ids', '-1', '--checkpoints_dir',
                                  str(tmp_path)],
        windows=1, window_steps=1, trace_steps=1, chunk=1)
    px = 256 if config.startswith('cgan') else 128
    assert rec['config'] == config
    assert rec['metric'] == 'vnc%d_%s_train_images_per_sec_per_chip' % (
        px, config[:-4])
    assert rec['finite'] is True and rec['value'] > 0
    assert rec['chunked_img_s'] > 0 and rec['backend'] == 'cpu'
    assert set(rec) == RECORD_KEYS | {'config'}
    for k in DEVICE_FIELDS:
        assert rec[k] is None, k


def test_bench_extra_cli_prints_one_record_a_config(tmp_path, monkeypatch,
                                                     capsys):
    """The command line: --configs picks the configurations, the other
    flags go to each."""
    monkeypatch.setattr(bench, 'WARMUP_STEPS', 1)
    monkeypatch.setattr(sys, 'argv', [
        'bench_extra', '--configs', 'fcgan_unsup_512', 'fcgan_joint_512',
        '--gpu_ids', '-1', '--checkpoints_dir', str(tmp_path)]
        + NARROW['fcgan_unsup_512'])
    recs = bench_extra.main(windows=1, window_steps=1, trace_steps=1,
                            chunk=1)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith('{"metric"')]
    assert [r['config'] for r in lines] == [r['config'] for r in recs] == [
        'fcgan_unsup_512', 'fcgan_joint_512']
