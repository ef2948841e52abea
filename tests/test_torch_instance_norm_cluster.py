"""The one-launch InstanceNorm + activation kernels' plan and arithmetic,
rehearsed on the CPU.

`in_plan` says how csrc/instance_norm.cu cuts each (n, c) plane into the
chunks of one block or of a thread-block cluster (chip_smoke.py holds the
library's own choice equal to it on the card).  The rehearsal below repeats
the kernels' arithmetic as the plan cuts it: f32 sums of each block's chunk,
the blocks' sums added in rank order 0..R-1, var = max(E[x^2] - mean^2, 0),
then the apply; it is held against the port's plain versions and against
the JAX package (`fused_instance_norm_act`'s XLA form and its VJP, and the
streaming `_stream_fwd` / `_stream_bwd` kernels in interpret mode).
Tolerance 1e-4 in f32: sums in another order, outputs of O(1); 2e-2 in
bf16, one bf16 ulp of outputs up to ~5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch.ops.kernels import instance_norm as kin

from test_torch_layout import nchw, nhwc, rand

SLOPES = [None, 0.0, 0.2]
DTYPES = [torch.float32, torch.bfloat16]
DIRECTIONS = ['forward', 'backward']
SMEM_PER_BLOCK = 227 * 1024      # the H100's largest dynamic shared memory

# the main path's IN sites, (N, C, H, W): the 512 px sampler's (C 64 at
# 16^2 to 512^2) and the bench.py DSGAN train step's, as chip_smoke.py
# records them (phase 5): G2's, F2's and the D banks' planes
SAMPLER_SITES = [(1, 64, s, s) for s in (16, 32, 64, 128, 256, 512)]
TRAIN_SITES = [
    (1, 32, 256, 256), (1, 64, 16, 16), (1, 64, 32, 32), (1, 64, 64, 64),
    (1, 64, 128, 128), (1, 64, 256, 256), (1, 64, 512, 512),
    (1, 128, 16, 16), (1, 128, 32, 32), (1, 128, 64, 64),
    (1, 128, 128, 128), (1, 256, 8, 8), (1, 256, 15, 15), (1, 256, 16, 16),
    (1, 256, 31, 31), (1, 256, 32, 32), (1, 256, 64, 64), (1, 512, 15, 15),
    (1, 512, 16, 16), (1, 512, 31, 31), (1, 512, 32, 32), (1, 512, 63, 63)]

# small shapes with odd sides (planes that start off a 16-byte boundary),
# N = 2; (2, 3, 91, 91) is large enough for a two-block cluster in f32
RAGGED = [(2, 1, 1, 1), (2, 1, 3, 5), (2, 3, 15, 15), (2, 5, 31, 31),
          (2, 3, 91, 91)]


def _vec(dtype):
    return 16 // (4 if dtype == torch.float32 else 2)


def _forced(h, w, dtype, cluster):
    """The plan's cut of an H x W plane into ``cluster`` chunks."""
    vec = _vec(dtype)
    chunk = kin._cdiv(kin._cdiv(h * w, cluster), vec) * vec
    return kin.InPlan('cluster' if cluster > 1 else 'block', cluster, chunk,
                      0, 128)


def _chunks(hw, plan):
    return [(min(r * plan.chunk, hw), min((r + 1) * plan.chunk, hw))
            for r in range(plan.cluster)]


def _fold(planes, plan, fn):
    """Per-block f32 sums of fn over each block's chunk of every plane,
    added in rank order: (NC,) float32 for each of fn's two terms."""
    t1 = torch.zeros(planes[0].shape[0], dtype=torch.float32)
    t2 = torch.zeros_like(t1)
    for b, e in _chunks(planes[0].shape[1], plan):
        a, c = fn(*(p[:, b:e] for p in planes))
        t1 = t1 + a.sum(1, dtype=torch.float32)
        t2 = t2 + c.sum(1, dtype=torch.float32)
    return t1, t2


def _act(z, slope):
    return z if slope is None else torch.where(z >= 0, z, z * slope)


def rehearse_fwd(x, eps, slope, plan):
    """instance_norm_act as the kernel computes it under ``plan``:
    (y in x's dtype, mean (N, C), rstd (N, C))."""
    n, c, h, w = x.shape
    xf = x.float().reshape(n * c, h * w)
    t1, t2 = _fold([xf], plan, lambda v: (v, v * v))
    mean = t1 / (h * w)
    var = (t2 / (h * w) - mean * mean).clamp_min(0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = _act((xf - mean[:, None]) * rstd[:, None], slope)
    return (y.reshape(x.shape).to(x.dtype), mean.reshape(n, c),
            rstd.reshape(n, c))


def rehearse_bwd(x, g, mean, rstd, slope, plan):
    """instance_norm_bwd as the kernel computes it under ``plan``."""
    n, c, h, w = x.shape
    m = mean.float().reshape(-1, 1)
    r = rstd.float().reshape(-1, 1)
    xf = x.float().reshape(n * c, h * w)
    gf = g.float().reshape(n * c, h * w)

    def terms(xv, gv):
        xh = (xv - m) * r
        gp = gv if slope is None else torch.where(xh >= 0, gv, gv * slope)
        return gp, gp * xh
    t1, t2 = _fold([xf, gf], plan, terms)
    gm, gz = (t1 / (h * w))[:, None], (t2 / (h * w))[:, None]
    xh = (xf - m) * r
    gp = gf if slope is None else torch.where(xh >= 0, gf, gf * slope)
    return ((gp - gm - xh * gz) * r).reshape(x.shape).to(x.dtype)


def _xg(shape, seed):
    return rand(shape, seed, 2.0) + 0.5, rand(shape, seed + 1)


def _nhwc_shape(shape):
    n, c, h, w = shape
    return (n, h, w, c)


# ------------------------------------------------------------- the plan -- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_in_plan_at_main_path_sites(dtype, direction):
    for n, c, h, w in SAMPLER_SITES + TRAIN_SITES:
        plan = kin.in_plan(n, c, h, w, dtype, direction)
        assert plan.route in ('block', 'cluster'), (n, c, h, w)
        assert (plan.route == 'block') == (plan.cluster == 1)
        assert plan.cluster <= 16 and plan.cluster & (plan.cluster - 1) == 0
        assert plan.threads in (128, 256, 512)
        assert plan.chunk % _vec(dtype) == 0
        # every block of the cluster holds part of the plane
        assert (plan.cluster - 1) * plan.chunk < h * w <= \
            plan.cluster * plan.chunk
        per = 2 if direction == 'backward' else 1
        assert plan.smem == (plan.chunk + _vec(dtype)) * per * (
            4 if dtype == torch.float32 else 2)
        assert plan.smem <= kin.MAX_SMEM <= SMEM_PER_BLOCK


def test_in_plan_main_path_routes():
    # the widest planes take clusters, the D banks' small ones one block
    f32, bf16 = torch.float32, torch.bfloat16
    assert kin.in_plan(1, 64, 512, 512, f32, 'backward') == kin.InPlan(
        'cluster', 16, 16384, 131104, 512)
    assert kin.in_plan(1, 64, 512, 512, f32, 'forward').cluster == 16
    assert kin.in_plan(1, 64, 512, 512, bf16, 'forward').cluster == 8
    assert kin.in_plan(1, 512, 15, 15, bf16, 'backward').route == 'block'
    assert kin.in_plan(1, 256, 8, 8, f32, 'forward').route == 'block'


def _two_pass_threshold(nc, dtype, direction):
    """The least H*W (a 1 x HW plane) that takes the two-pass route."""
    lo, hi = 1, 1 << 26
    while lo < hi:
        mid = (lo + hi) // 2
        if kin.in_plan(1, nc, 1, mid, dtype, direction).route == 'two_pass':
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_in_plan_two_pass_above_threshold(dtype, direction):
    hw = _two_pass_threshold(6, dtype, direction)
    below = kin.in_plan(1, 6, 1, hw - 1, dtype, direction)
    above = kin.in_plan(1, 6, 1, hw, dtype, direction)
    assert below.route == 'cluster' and below.cluster == 16
    assert below.smem <= kin.MAX_SMEM
    assert above.route == 'two_pass' and above.smem == 0
    assert above.cluster == kin.splits_for(hw)
    # 16 blocks hold at most 16 x MAX_SMEM bytes of a plane
    per = (2 if direction == 'backward' else 1) * (
        4 if dtype == torch.float32 else 2)
    assert hw * per > 16 * (kin.MAX_SMEM - 16 * per)
    # a 1024^2 f32 plane takes it both ways
    if dtype == torch.float32:
        assert kin.in_plan(1, 2, 1024, 1024, dtype, direction).route == \
            'two_pass'


def test_in_plan_refuses_unknown_direction():
    with pytest.raises(ValueError):
        kin.in_plan(1, 1, 4, 4, torch.float32, 'sideways')


# -------------------------------------------------------- the rehearsal -- #

@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("shape", RAGGED)
def test_rehearsal_forward_matches_plain_and_xla(shape, slope):
    x, _ = _xg(_nhwc_shape(shape), 10)
    xt = nchw(x)
    plan = kin.in_plan(*shape, torch.float32, 'forward')
    y, mean, rstd = rehearse_fwd(xt, 1e-5, slope, plan)
    yp, mp, rp = kin.instance_norm_act_plain(xt, 1e-5, slope,
                                             return_stats=True)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mean, mp, rtol=0, atol=1e-4 * float(
        mp.abs().max()) + 1e-7)
    torch.testing.assert_close(rstd, rp, rtol=0,
                               atol=1e-4 * float(rp.abs().max()))
    ref = sin.fused_instance_norm_act(jnp.asarray(x), 1e-5, slope)
    np.testing.assert_allclose(nhwc(y), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("shape", RAGGED)
def test_rehearsal_backward_matches_plain_and_fused_vjp(monkeypatch, shape,
                                                        slope):
    monkeypatch.setattr(sin, '_FMA', False)
    x, g = _xg(_nhwc_shape(shape), 20)
    xt, gt = nchw(x), nchw(g)
    _, mean, rstd = kin.instance_norm_act_plain(xt, 1e-5, None,
                                                return_stats=True)
    plan = kin.in_plan(*shape, torch.float32, 'backward')
    dx = rehearse_bwd(xt, gt, mean, rstd, slope, plan)
    torch.testing.assert_close(
        dx, kin.instance_norm_bwd_plain(xt, gt, mean, rstd, slope),
        rtol=1e-4, atol=1e-4)
    _, pull = jax.vjp(lambda v: sin.fused_instance_norm_act(v, 1e-5, slope),
                      jnp.asarray(x))
    (ref,) = pull(jnp.asarray(g))
    np.testing.assert_allclose(nhwc(dx), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
def test_rehearsal_clusters_match_stream_kernels_interpret(monkeypatch,
                                                           cluster, slope):
    # a 64 @16^2 site cut into 1-16 chunks, against the JAX streaming
    # kernels (instance_norm.py:297-344 there) run in interpret mode
    x, g = _xg((1, 16, 16, 64), 30)
    xj = jnp.asarray(x)
    monkeypatch.setattr(sin, '_INTERPRET', True)
    assert sin.stream_supported(xj)
    yj, mj, rj = sin._stream_fwd(xj, 1e-5, slope)
    dxj = sin._stream_bwd(xj, jnp.asarray(g), mj, rj, slope)
    plan = _forced(16, 16, torch.float32, cluster)
    y, mean, rstd = rehearse_fwd(nchw(x), 1e-5, slope, plan)
    np.testing.assert_allclose(nhwc(y), np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rj), rtol=1e-5)
    dx = rehearse_bwd(nchw(x), nchw(g), mean, rstd, slope, plan)
    np.testing.assert_allclose(nhwc(dx), np.asarray(dxj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("cluster", [2, 8, 16])
def test_rehearsal_ragged_chunks(cluster):
    # a 31^2 plane cut into chunks that end off a vector: each block's
    # sums and the rank-order fold still give the plane's statistics
    x, g = _xg((2, 31, 31, 3), 40)
    xt, gt = nchw(x), nchw(g)
    plan = _forced(31, 31, torch.float32, cluster)
    assert _chunks(31 * 31, plan)[-1][1] == 31 * 31
    y, mean, rstd = rehearse_fwd(xt, 1e-5, 0.2, plan)
    torch.testing.assert_close(y, kin.instance_norm_act_plain(xt, 1e-5, 0.2),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        rehearse_bwd(xt, gt, mean, rstd, 0.2, plan),
        kin.instance_norm_bwd_plain(xt, gt, mean, rstd, 0.2),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_rehearsal_bf16_matches_plain(direction):
    x, g = _xg((2, 63, 63, 3), 50)
    xt, gt = nchw(x).bfloat16(), nchw(g).bfloat16()
    plan = kin.in_plan(2, 3, 63, 63, torch.bfloat16, direction)
    if direction == 'forward':
        ours = rehearse_fwd(xt, 1e-5, 0.0, plan)[0]
        ref = kin.instance_norm_act_plain(xt, 1e-5, 0.0)
    else:
        _, mean, rstd = kin.instance_norm_act_plain(xt, 1e-5, None,
                                                    return_stats=True)
        ours = rehearse_bwd(xt, gt, mean, rstd, 0.0, plan)
        ref = kin.instance_norm_bwd_plain(xt, gt, mean, rstd, 0.0)
    assert ours.dtype == torch.bfloat16
    torch.testing.assert_close(ours.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
