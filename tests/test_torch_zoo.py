"""The rest of the network zoo of the port on the CPU against the JAX
package's: fcgan_star, autoencoder, the dcgan G and D, n_layers_sep; and
`models/common.py` `g_apply` on every generator name.

Each net at small widths from one numpy-made parameter set
(from_jax_params): the forward within 1e-5 of the output's largest entry,
and through jax.vjp the gradient of every parameter and of the input
(within 1e-4 of the tensor's largest entry, plus 1e-7), in f32.  The
autoencoder runs with its Dropout layers present and p set to 0 on both
sides, so the InstanceNorm before each runs without its activation, as it
does in training, and its mask takes no draw.  Parameter counts equal the
golden ones of tests/test_networks.py:205-264 at those configurations; the
.pth files of either package load strictly into the other.

g_apply hands the noise-only generators (fcgan, fcgan_star, dcgan) the
noise, the CRN the label and the noise, the others the label, as the JAX
g_apply does; a registry test builds every name the JAX factory accepts.

One f32 step of `--model cgan --which_model_netG fcgan --which_channel
r_g` (a noise-only G in a conditional recipe) against the JAX step, as
tests/test_torch_cgan.py holds the cgan step: the metrics within 1e-5, the
gradients within 1e-4 of the tensor's largest entry, and every parameter
after the step within 1e-4 of its largest entry, plus 2 lr per Adam step
where |g| is below the gradient tolerance.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.models import common as jcommon
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.nn import factory as jfactory
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.models import common as tcommon
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, one_thread  # noqa

KEY = jax.random.PRNGKey(0)

# name -> (build(m) for the package m, its input (NHWC shape), what the
# input is: 'noise' for a noise-only G, 'x' for the others)
NETS = {
    'fcgan_star': (lambda m: m.define_G(2, 0, 4, 'fcgan_star', 'instance',
                                        False, n_layers_G=5, use_fcn=True,
                                        noise_nc=8),
                   (1, 2, 2, 8), 'noise'),
    'autoencoder_dropout': (lambda m: m.define_G(2, 1, 4, 'autoencoder',
                                                 'instance', True,
                                                 n_layers_G=3),
                            (1, 64, 64, 2), 'x'),
    'autoencoder_batch': (lambda m: m.define_G(3, 3, 4, 'autoencoder',
                                               'batch', False, n_layers_G=4),
                          (2, 64, 64, 3), 'x'),
    'dcgan_G': (lambda m: m.define_G(3, 0, 8, 'dcgan', 'instance', False,
                                     noise_nc=16),
                (1, 1, 1, 16), 'noise'),
    'dcgan_G_batch2': (lambda m: m.define_G(3, 0, 8, 'dcgan', 'instance',
                                            False, noise_nc=16),
                       (2, 1, 1, 16), 'noise'),
    'dcgan_D': (lambda m: m.define_D(3, 8, 'dcgan', norm='instance'),
                (2, 128, 128, 3), 'x'),
    'n_layers_sep_3': (lambda m: m.define_D(3, 4, 'n_layers_sep',
                                            n_layers_D=3, norm='instance',
                                            use_sigmoid=True,
                                            scale_factor=1),
                       (1, 64, 64, 3), 'x'),
    'n_layers_sep_4_blur': (lambda m: m.define_D(3, 4, 'n_layers_sep',
                                                 n_layers_D=4, norm='batch',
                                                 scale_factor=2),
                            (1, 128, 128, 3), 'x'),
}


def _pair(name, seed):
    """The JAX and the port's net of ``name`` with one parameter set."""
    build = NETS[name][0]
    j, t = build(jnn), build(tnn)
    params = jax_params(j, seed)
    t.load_state_dict(from_jax_params(t, params), strict=True)
    return j, t, params


def _dropout_off(j, t):
    """p = 0 on every Dropout of both sides (JAX and the port return the
    input unchanged at p 0); returns how many each has."""
    jd = [lay for lay in _jax_layers(j) if isinstance(lay, jnn.Dropout)]
    td = [m for m in t.modules() if isinstance(m, tnn.Dropout)]
    for d in jd + td:
        d.p = 0.0
    return len(jd), len(td)


def _jax_layers(layer):
    yield layer
    for child in layer.children().values():
        yield from _jax_layers(child)


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_and_vjp_match_jax(name, monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    j, t, params = _pair(name, 30)
    if 'dropout' in name:
        assert _dropout_off(j, t) == (4, 4)
    _, shape, kind = NETS[name]
    rng = np.random.RandomState(1)
    x = (rng.standard_normal(shape) if kind == 'noise'
         else rng.uniform(-1, 1, shape)).astype(np.float32)

    def fwd(p, xx):
        return j.apply(p, xx, jnn.Ctx(KEY))

    y = jax.jit(fwd)(params, jnp.asarray(x))
    ct = rng.standard_normal(y.shape).astype(np.float32)
    gp, gx = jax.device_get(jax.jit(
        lambda p, xx, c: jax.vjp(fwd, p, xx)[1](c))(
            params, jnp.asarray(x), jnp.asarray(ct)))

    xt = nchw(x).requires_grad_(True)
    yt = t(xt)
    if yt.dim() == 1:                   # the dcgan D: one score a sample
        assert yt.shape == y.shape == (shape[0],)
        ours, ref = yt.detach().numpy(), np.asarray(y)
        ctt = torch.from_numpy(ct)
    else:
        ours, ref, ctt = nhwc(yt), np.asarray(y), nchw(ct)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)
    (yt * ctt).sum().backward()
    gx_ref = nchw(gx)
    assert float((xt.grad - gx_ref).abs().max()) <= (
        1e-7 + 1e-4 * float(gx_ref.abs().max()))
    ref_g = from_jax_params(t, gp)
    for n, p in t.named_parameters():
        if p.grad is None:              # an inert bias: exactly 0 there
            assert n.endswith('bias') and not ref_g[n].abs().max() > 0, n
            continue
        err = float((p.grad - ref_g[n]).abs().max())
        assert err <= 1e-7 + 1e-4 * float(ref_g[n].abs().max()), (n, err)


# tests/test_networks.py:205-264: the golden counts at their configurations
GOLDEN = {
    'autoencoder': (lambda m: m.define_G(3, 3, 64, 'autoencoder', 'instance',
                                         False, n_layers_G=3), 1383040),
    'fcgan_star': (lambda m: m.define_G(2, 0, 64, 'fcgan_star', 'instance',
                                        False, n_layers_G=5, use_fcn=True,
                                        noise_nc=8), 20914944),
    'dcgan_G': (lambda m: m.define_G(3, 0, 64, 'dcgan', 'instance', False,
                                     noise_nc=100), 3608000),
    'dcgan_D': (lambda m: m.define_D(3, 64, 'dcgan', norm='instance'),
                2796928),
    'n_layers_sep': (lambda m: m.define_D(3, 64, 'n_layers_sep',
                                          n_layers_D=4, norm='instance',
                                          scale_factor=1), 7615105),
}


@pytest.mark.parametrize('name', sorted(GOLDEN))
def test_golden_parameter_counts(name):
    build, golden = GOLDEN[name]
    j, t = build(jnn), build(tnn)
    shapes = jax.eval_shape(j.init, KEY)
    assert tnn.count_params(t) == jnn.count_params(shapes) == golden


@pytest.mark.parametrize('name', sorted(NETS))
def test_pth_both_ways_strict(name, tmp_path):
    """A .pth the JAX package writes loads into the port with strict=True
    (the BatchNorm running buffers included), and the port's loads into
    the JAX package (its strict shape check), value for value."""
    j, t, params = _pair(name, 31)
    path = str(tmp_path / 'j.pth')
    jpth.save_pth(path, j, params)
    fresh = NETS[name][0](tnn)
    fresh.load_state_dict(torch.load(path, weights_only=True), strict=True)
    for (na, a), (nb, b) in zip(fresh.state_dict().items(),
                                t.state_dict().items()):
        assert na == nb and torch.equal(a, b), na
    back = str(tmp_path / 't.pth')
    torch.save(t.state_dict(), back)
    loaded = jpth.load_pth(back, j)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(loaded)[0])
    assert len(got) == len(flat)
    for path_, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path_]),
                                      np.asarray(leaf))


# every generator name of the JAX factory at tiny widths: (build kwargs,
# label (NHWC), noise (NHWC))
G_APPLY = {
    'fcgan': (dict(input_nc=2, output_nc=0, ngf=4, n_layers_G=3,
                   use_fcn=True, noise_nc=4), (1, 40, 40, 2), (1, 2, 2, 4)),
    'deconv': (dict(input_nc=2, output_nc=0, ngf=4, n_layers_G=3,
                    use_fcn=False, noise_nc=4), (1, 40, 40, 2),
               (1, 1, 1, 4)),
    'fcgan_star': (dict(input_nc=2, output_nc=0, ngf=2, n_layers_G=5,
                        use_fcn=True, noise_nc=4), (1, 40, 40, 2),
                   (1, 1, 2, 4)),
    'dcgan': (dict(input_nc=3, output_nc=0, ngf=4, noise_nc=8),
              (1, 40, 40, 3), (1, 1, 1, 8)),
    'crn': (dict(input_nc=2, output_nc=1, ngf=4, n_layers_G=5, noise_nc=4),
            (1, 64, 64, 2), (1, 1, 1, 4)),
    'autoencoder': (dict(input_nc=2, output_nc=1, ngf=4, n_layers_G=3),
                    (1, 32, 32, 2), (1, 1, 1, 4)),
    'unet_128': (dict(input_nc=2, output_nc=1, ngf=2), (1, 128, 128, 2),
                 (1, 1, 1, 4)),
    'unet_256': (dict(input_nc=2, output_nc=1, ngf=2), (1, 256, 256, 2),
                 (1, 1, 1, 4)),
    'resnet_6blocks': (dict(input_nc=3, output_nc=3, ngf=2),
                       (1, 24, 24, 3), (1, 1, 1, 4)),
    'resnet_9blocks': (dict(input_nc=3, output_nc=3, ngf=2),
                       (1, 24, 24, 3), (1, 1, 1, 4)),
}


def _jax_names(kind):
    """Every model name the JAX factory's define_G / define_D compares
    which_model_net<kind> against."""
    import inspect
    src = inspect.getsource(jfactory)
    names = set()
    for m in re.finditer(r"which_model_net%s (==|in) (\([^)]*\)|'[^']*')"
                         % kind, src):
        names.update(re.findall(r"'([^']*)'", m.group(2)))
    return names


def test_registry_builds_every_jax_name():
    """define_G / define_D build every name the JAX factory accepts, and
    reject an unknown one with NotImplementedError, as it does."""
    g_names, d_names = _jax_names('G'), _jax_names('D')
    assert g_names == set(G_APPLY)
    assert d_names == {'basic', 'n_layers', 'n_layers_sep', 'dcgan'}
    for name in sorted(g_names):
        kw = G_APPLY[name][0]
        assert type(tnn.define_G(which_model_netG=name, norm='instance',
                                 **kw)).__name__ == type(jnn.define_G(
                                     which_model_netG=name, norm='instance',
                                     **kw)).__name__
    for name in sorted(d_names):
        assert type(tnn.define_D(3, 4, name)).__name__ == type(
            jnn.define_D(3, 4, name)).__name__
    for define in (tnn.define_G, jnn.define_G):
        with pytest.raises(NotImplementedError, match='nope'):
            define(2, 1, 4, 'nope')
    for define in (tnn.define_D, jnn.define_D):
        with pytest.raises(NotImplementedError, match='nope'):
            define(3, 4, 'nope')


@pytest.mark.parametrize('name', sorted(G_APPLY))
def test_g_apply_matches_jax(name, monkeypatch):
    """g_apply with a label and a noise of different shapes: the output
    equals the JAX g_apply's (1e-5 of its largest entry)."""
    monkeypatch.setattr(sin, '_FMA', False)
    kw, xshape, nshape = G_APPLY[name]
    j = jnn.define_G(which_model_netG=name, norm='instance', **kw)
    t = tnn.define_G(which_model_netG=name, norm='instance', **kw)
    params = jax_params(j, 32)
    t.load_state_dict(from_jax_params(t, params), strict=True)
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, xshape).astype(np.float32)
    noise = rng.standard_normal(nshape).astype(np.float32)
    y = jax.jit(lambda p, xx, z: jcommon.g_apply(
        j, p, jnn.Ctx(KEY), x=xx, noise=z))(params, jnp.asarray(x),
                                            jnp.asarray(noise))
    with torch.no_grad():
        yt = tcommon.g_apply(t, nchw(x), nchw(noise), torch.float32)
    ref = np.asarray(y)
    assert nhwc(yt).shape == ref.shape
    assert np.abs(nhwc(yt) - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)


# --model cgan with the noise-only fcgan G: r -> g, 64 px from 2^2 noise
CG_FLAGS = ['--dataroot', './datasets/unused', '--name', 'cgfc',
            '--model', 'cgan', '--which_direction', 'AtoB',
            '--dataset_mode', 'single', '--loadSize', '64', '--fineSize', '64',
            '--batchSize', '1', '--which_model_netG', 'fcgan',
            '--n_layers_G', '4', '--ngf', '4', '--noise_nc', '4',
            '--noiseSize', '2', '--norm', 'instance', '--which_channel', 'r_g',
            '--which_model_netD', 'n_layers', '--n_layers_D', '2',
            '--ndf', '4', '--scale_factor', '1', '--lambda_D', '1',
            '--lambda_A', '10', '--n_update_G', '2', '--no_lsgan',
            '--lr', '0.0002', '--manualSeed', '0', '--display_id', '0',
            '--pool_size', '0', '--no_dropout']
LR = 2e-4


def _numpy_init(layer, key):
    """Stands in for the JAX package's jit_init where the test replaces the
    values (its own init runs eagerly, an XLA compile per op)."""
    return jax_params(layer, 0)


def _cg_batch():
    a = np.random.RandomState(3).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    a[..., 0] = np.sign(a[..., 0])
    return {'A': a, 'A_paths': ['x.png']}


@pytest.fixture(scope='module')
def cgan_fcgan_step(tmp_path_factory):
    flags = CG_FLAGS + ['--checkpoints_dir',
                        str(tmp_path_factory.mktemp('cgfc'))]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        params = {'G': jax_params(jm.netG, 70),
                  'D': {'0': jax_params(jm.netD[0], 71)}}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
        tm.netG.load_state_dict(from_jax_params(tm.netG, params['G']),
                                strict=True)
        tm.netD[0].load_state_dict(from_jax_params(tm.netD[0],
                                                   params['D']['0']),
                                   strict=True)
        jm.set_input(_cg_batch())
        tm.set_input(_cg_batch())
        key = jm.next_step_key()
        # the noise of the first forward and of the redraws after the two G
        # updates (models/common.py build_gan_train_step there)
        shape = (1, 2, 2, 4)
        noises = iter([nchw(jax.random.normal(jax.random.fold_in(key, i),
                                              shape)) for i in (0, 3, 5)])
        tm.draw_noise = lambda: next(noises)

        new, metrics, (g_d, _, g_g) = jax_step(jm, key, jm.lrs(), mp)
        tm.optimize_parameters()
        assert next(noises, None) is None
        return dict(port=tm, metrics=jax.device_get(metrics),
                    grads=jax.device_get({'G': g_g['G'], 'D': g_d['0']}),
                    params=jax.device_get({'G': new['params']['G'],
                                           'D': new['params']['D']['0']}))
    finally:
        mp.undo()


def test_cgan_fcgan_step_metrics_match_jax(cgan_fcgan_step):
    ours = cgan_fcgan_step['port'].get_current_errors()
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(cgan_fcgan_step['metrics'][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize('kind', ['G', 'D'])
def test_cgan_fcgan_step_params_match_jax(cgan_fcgan_step, kind):
    """The gradient of the last update of each net, and every parameter
    after the step (G two Adam steps, D one)."""
    m = cgan_fcgan_step['port']
    mod = m.netG if kind == 'G' else m.netD[0]
    assert_step_matches(mod, cgan_fcgan_step['grads'][kind],
                        cgan_fcgan_step['params'][kind],
                        2 if kind == 'G' else 1)


def jax_step(jm, key, lrs, mp):
    """The JAX model's step function, jitted, on its state: (the new state,
    the metrics, the gradients each Adam update took, in order)."""
    captured = []
    orig = jbase.FlatAdam.apply_updates

    def capture(self, grads, state, p, leaves_lr):
        captured.append(grads)
        return orig(self, grads, state, p, leaves_lr)

    mp.setattr(jbase.FlatAdam, 'apply_updates', capture)

    def step_with_grads(state, inputs, k, lr):
        captured.clear()
        new, metrics, _ = jm._raw_step_fn(state, inputs, k, lr)
        return new, metrics, list(captured)

    return jax.device_get(jax.jit(step_with_grads)(
        jm.state, jm._step_inputs(), key, lrs))


def assert_step_matches(mod, grads, params, n_steps, lr=LR):
    """A port net after a step against the JAX net's: the gradient of its
    last update within 1e-4 of the tensor's largest entry (plus 1e-7; an
    inert bias has none, and a zero one there), and every parameter within
    1e-4 of its largest entry, plus 2 lr for each of its ``n_steps`` Adam
    steps where |g| is below that tolerance (Adam turns a rounding-sized
    gradient into +-lr)."""
    g = from_jax_params(mod, grads)
    ref = from_jax_params(mod, params)
    for name, p in mod.named_parameters():
        gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
        if p.grad is None:
            assert name.endswith('bias') and not g[name].abs().max() > 0, name
        else:
            err = float((p.grad - g[name]).abs().max())
            assert err <= gtol, (name, err, gtol)
        allow = (1e-4 * float(ref[name].abs().max())
                 + 2 * n_steps * lr * (g[name].abs() < gtol).float())
        assert torch.all((p.detach() - ref[name]).abs() <= allow), name
