"""The benchmark's arithmetic on made-up numbers: the end-to-end metrics of
a window, the trace's busy union, gaps and launch counts, the rooflines'
operations and bytes, the site recorder and the FLOP count."""

import re
import types

import pytest
import torch

from portbench import check, harness, roofline, trace
from portbench.reference import nets
from portbench.reference.ctx import Ctx, Draws


def window(times, steps=10):
    """Dispatches of the given seconds back to back, each call returning at
    a tenth of its time."""
    out, t = [], 100.0
    for s in times:
        out.append((t, t + s / 10, t + s, steps))
        t += s
    return out


def test_one_stalled_dispatch_moves_rate_and_tail():
    """A stall moves the rate wherever it falls; the 90th percentile (the
    nearest rank) moves when the stalled dispatches are a tenth of the
    window's or more, and ignores a rarer one."""
    even = harness.end_to_end(window([0.25] * 9), 1, 5.0)
    stalled = harness.end_to_end(window([0.25] * 8 + [2.0]), 1, 5.0)
    assert even['train_img_s'] == pytest.approx(90 / 2.25)
    assert even['step_ms_p90'] == pytest.approx(25.0)
    assert stalled['train_img_s'] < 0.6 * even['train_img_s']
    assert stalled['step_ms_p90'] == pytest.approx(200.0)
    rare = harness.end_to_end(window([0.25] * 19 + [2.0]), 1, 5.0)
    assert rare['step_ms_p90'] == pytest.approx(25.0)
    assert rare['train_img_s'] < 0.8 * even['train_img_s']
    assert stalled['setup_s'] == 5.0


class Event:
    def __init__(self, name, start_us, end_us, device):
        self.name = self.key = name
        self.time_range = types.SimpleNamespace(start=start_us, end=end_us)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)


def summary(events, steps=2):
    prof = types.SimpleNamespace(events=lambda: events)
    return trace.Summary(prof, steps)


def test_idle_share_of_a_known_gap_is_exact():
    spins = [Event('cudaLaunchKernel', 0, 1, False)] * trace.PRIMER_SPINS
    ev = spins + [
        Event(trace.DISPATCH_SPAN, 1000, 2000, False),
        Event('aten::copy_', 1200, 1500, False),
        Event('cudaLaunchKernel', 1010, 1020, False),
        Event('cudaLaunchKernel', 1600, 1610, False),
        Event('cudaGraphLaunch', 1620, 1630, False),
        Event('k_a', 1000, 1200, True),
        Event('k_b', 1100, 1150, True),      # inside k_a: counted once
        Event('Memcpy HtoD', 1500, 1600, True),
        Event('k_c', 1900, 2100, True),      # cut at the window's end
    ]
    s = summary(ev)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s() == pytest.approx(400e-6)
    assert [tuple(round(x * 1e6) for x in g) for g in s.gaps()] == [
        (1200, 1500), (1600, 1900)]
    assert s.launches_outside == 2 and s.graph_launches == 1
    b = s.breakdown()
    assert b['idle_gaps'][0][0] == 'aten::copy_'
    assert b['idle_gaps'][0][1] == pytest.approx(300e-6)
    assert b['device_ops'][0][0] in ('k_a', 'k_c')
    r = types.SimpleNamespace(trace=s)
    idle = harness.reader('device.idle_share')(r)
    assert idle == pytest.approx(60.0)


def readings(events, sites, steps=4):
    """The Readings of a traced stretch of ``events`` and of recorded
    ``sites``, with no window."""
    run = types.SimpleNamespace(mix={'batch': 1, 'steps_per_dispatch': 10},
                                sites=sites)
    return harness.Readings(run, [], summary(events, steps=steps), None)


def test_readers_split_hand_kernels_from_the_library():
    ev = [Event(trace.DISPATCH_SPAN, 0, 1000, False),
          Event('void (anonymous namespace)::conv3x3_tc_kernel<__nv_bfloat16'
                ', 2>(int)', 0, 300, True),
          Event('cudnn_conv_kernel', 300, 500, True),
          Event('Memset (Device)', 500, 600, True)]
    site = roofline.Site('conv3x3', 1.0, 1.0, 30e-6, 'conv3x3')
    r = readings(ev, [site] * 2)
    assert harness.reader('kernels.ms_per_step')(r) == pytest.approx(0.075)
    assert harness.reader('ops.library_ms_per_step')(r) == pytest.approx(
        0.075)
    # 2 calls of 30 us a step over 4 steps against 300 us of hand kernels
    assert harness.reader('hand_kernels_roofline')(r) == pytest.approx(80.0)


def test_families_match_the_program_kernels():
    """One family a csrc/<family>.cu of the program: its entries are names
    of ops.kernels.functions, its device names the file's kernels, each
    claimed by one family; the per-family lookup tells one family's from
    another's."""
    from supervised_gan_tpu_torch.ops.kernels import functions
    csrc = harness.ROOT / 'supervised_gan_tpu_torch' / 'csrc'
    fams = roofline.families()
    assert set(fams) == {p.stem for p in csrc.glob('*.cu')}
    entries = [e for f in fams.values() for e in f.ENTRIES]
    names = [n for f in fams.values() for n in f.DEVICE_NAMES]
    assert len(entries) == len(set(entries))
    assert len(names) == len(set(names))
    for family, fam in fams.items():
        kernels = set(re.findall(r'__global__ void(?: __launch_bounds__\s*'
                                 r'\([^)]*\))?\s+(\w+)',
                                 (csrc / (family + '.cu')).read_text()))
        assert set(fam.DEVICE_NAMES) == kernels, family
        assert all(callable(getattr(functions, e, None))
                   for e in fam.ENTRIES), family
    sites = [roofline.Site('conv3x3', 1.0, 1.0, 1e-6, 'conv3x3'),
             roofline.Site('conv3x3_in_stats', 1.0, 1.0, 1e-6, 'conv3x3_in')]
    r = readings([Event(trace.DISPATCH_SPAN, 0, 1000, False)], sites)
    op = 'void (anonymous namespace)::conv3x3_in_tc_kernel<float>(int)'
    assert r.is_family('conv3x3_in', op) and r.is_hand(op)
    assert not r.is_family('conv3x3', op)
    assert [s.entry for s in r.family_sites('conv3x3_in')] == [
        'conv3x3_in_stats']
    twice = dict(fams, again=fams['conv3x3'])
    with pytest.raises(ValueError, match='conv3x3'):
        with roofline.recording(types.SimpleNamespace(), twice):
            pass


def test_conv_costs_and_bounds():
    fams = roofline.families()
    x = torch.empty(2, 16, 32, 32, dtype=torch.bfloat16)
    w = torch.empty(8, 16, 3, 3, dtype=torch.bfloat16)
    flops, nbytes = fams['conv3x3'].cost('conv3x3', (x, w, None))
    assert flops == 2.0 * 2 * 8 * 32 * 32 * 16 * 9
    assert nbytes == 2 * (x.numel() + w.numel() + 2 * 8 * 32 * 32)
    assert fams['conv3x3'].peak('conv3x3', (x, w)) == \
        roofline.PEAK_BF16_FLOPS
    f, b = fams['convt4s2'].cost('convt4s2', (x, torch.empty(16, 8, 4, 4)))
    assert f == 2.0 * 2 * 8 * 64 * 64 * 16 * 4
    f, b = fams['conv4s2'].cost('conv4s2',
                                (x.float(), torch.empty(8, 16, 4, 4)))
    assert f == 2.0 * 2 * 8 * 16 * 16 * 16 * 16
    assert fams['conv4s2'].peak('conv4s2', (x.float(),)) == \
        roofline.PEAK_TF32X3_FLOPS
    assert fams['instance_norm'].peak('instance_norm_act', (x.float(),)) == \
        roofline.PEAK_F32_FLOPS
    assert roofline.bound_s(1e12, 0, 1e12) == 1.0
    assert roofline.bound_s(0, roofline.PEAK_BYTES, 1e12) == 1.0


def test_recorder_counts_calls_and_restores():
    def conv3x3(x, w, b=None):
        return 'y'
    mod = types.SimpleNamespace(conv3x3=conv3x3)
    x = torch.empty(1, 4, 8, 8)
    with roofline.recording(mod, roofline.families()) as calls:
        assert mod.conv3x3(x, torch.empty(2, 4, 3, 3)) == 'y'
        mod.conv3x3(x, torch.empty(2, 4, 3, 3))
    assert mod.conv3x3 is conv3x3
    assert [c[0] for c in calls] == ['conv3x3', 'conv3x3']
    assert calls[0][1] == 2.0 * 2 * 64 * 4 * 9


def test_flop_count_of_one_conv_and_of_a_step():
    from torch.utils.flop_counter import FlopCounterMode
    conv = nets.Conv(4, 8, 4, 2, 1).to('meta')
    x = torch.empty(3, 4, 16, 16, device='meta')
    with FlopCounterMode(display=False) as fc:
        conv.run(x, Ctx(Draws(0, 'meta')))
    assert fc.get_total_flops() == 2 * 3 * 8 * 8 * 8 * 4 * 16
    conf = harness.load_json(harness.PKG / 'configs' /
                             'sgan-cgan-512-bf16.json')
    flags = dict(conf['flags'], **conf['cpu_test_flags'])
    recipe = harness.recipe_class('sgan-cgan-512-bf16.json', conf)
    one = harness.step_flops(recipe, flags, 1)
    eight = harness.step_flops(recipe, flags, 8)
    assert one > 0 and eight == pytest.approx(8 * one, rel=1e-9)


def test_gaps_and_verdict():
    ref = {'losses': [{'a': 1.0, 'c': 2.0}] * 3, 'steps': [1, 2, 12],
           'moments': {'w': 1.0, 'v': 2.0, 'b': 1e-9},
           'change': {'w': 1.0, 'v': 1.0, 'b': 1.0}}
    prog = {'losses': [{'a': 1.01, 'c': 2.0}] * 2 + [{'a': 1.5, 'c': 2.002}],
            'moments': {'w': 1.1, 'v': 2.0},
            'change': {'w': 1.0, 'v': 1.0, 'b': 0.0}}
    found = check.gaps(prog, ref, {'loss12_c': {'of': 'loss12',
                                                'losses': ['c']}})
    assert sorted(found) == ['change', 'grad', 'loss1', 'loss12',
                             'loss12_c', 'loss2']
    assert found['loss1'] == (pytest.approx(0.01), 'a')
    assert found['loss12'] == (pytest.approx(0.5), 'a')
    # a subset reads its own losses alone
    assert found['loss12_c'] == (pytest.approx(0.001), 'c')
    assert found['grad'] == (pytest.approx(0.1), 'w')
    # the bias whose moment is rounding-sized is left out of the change
    assert found['change'][0] == 0.0
    ok, checks = check.verdict(found, {'loss1': 0.02, 'grad': 0.05})
    assert not ok and checks['grad']['value'] == pytest.approx(0.1)
    nan = check.gaps(dict(prog, losses=[{'a': float('nan'), 'c': 2.0}] * 3),
                     ref)
    assert not check.verdict(nan, {'loss1': 1.0})[0]
    lost = check.gaps(dict(prog, losses=[{'c': 2.0}] * 3), ref)
    assert not check.verdict(lost, {'loss2': 1.0})[0]


def test_pool_images_and_traffic_draws():
    """The pools' and the traffic's images: each image's channel its own
    statistics within the mix's ranges, the same from one seed."""
    mix = harness.traffic.load(harness.PKG / 'traffic' / 'b1.chunk10.json')
    conf = harness.load_json(harness.PKG / 'configs' /
                             'sgan-cgan-512-bf16.json')
    flags = dict(conf['flags'], fineSize=64, ngf=4, ndf=4)
    recipe = harness.recipe_class('sgan-cgan-512-bf16.json', conf)(flags,
                                                                  'cpu')
    fill = harness.pool_images(recipe, mix, 5, 'cpu')
    assert list(fill) == ['fake']
    x = fill['fake']
    assert x.shape == (50, 3, 64, 64)
    lo = mix['mean_low'] - mix['amp_high']
    hi = mix['mean_high'] + mix['amp_high']
    assert lo <= float(x.min()) and float(x.max()) <= hi
    means = x.mean(dim=(2, 3))
    assert float(means.std()) > 0.1
    assert torch.equal(x, harness.pool_images(recipe, mix, 5, 'cpu')['fake'])
    imgs = harness.traffic.images(mix, 32, 5, 'cpu')
    assert imgs.shape == (64, 32, 32, 3)
    assert float(imgs.mean(dim=(1, 2)).std()) > 0.1
