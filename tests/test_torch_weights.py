"""JAX parameter trees and JAX-written .pth files carried into the port's
generators: strict loading, parameter counts, and numerics through the
loaded weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.utils import pth as tpth
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, rand
from test_torch_layout import one_thread  # noqa: F401

# small widths of the DSGAN sampler's two generators (G1 fcgan, G2 CRN with
# bilinear upsampling, 2-conv blocks and InstanceNorm)
CONFIGS = {
    'fcgan': dict(args=(2, 0, 8, 'fcgan', 'instance', False),
                  kw=dict(n_layers_G=3, use_fcn=True, noise_nc=4)),
    'crn': dict(args=(2, 1, 16, 'crn', 'instance', False),
                kw=dict(n_layers_G=5, noise_nc=4, upsample_mode='bilinear',
                        n_layers_CRN_block=2)),
}


def build_pair(name, seed=0):
    cfg = CONFIGS[name]
    jnet = jnn.define_G(*cfg['args'], **cfg['kw'])
    params = jax_params(jnet, seed)
    tnet = tnn.define_G(*cfg['args'], **cfg['kw'])
    return jnet, params, tnet


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_jax_params_loads_strict(name):
    _, params, tnet = build_pair(name)
    sd = from_jax_params(tnet, params)
    tnet.load_state_dict(sd, strict=True)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_counts_match_jax(name):
    _, params, tnet = build_pair(name)
    assert tnn.count_params(tnet) == jnn.count_params(params)
    assert tnn.print_network(tnet, name) == jnn.count_params(params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_written_pth_loads_strict(tmp_path, name):
    jnet, params, tnet = build_pair(name, seed=1)
    path = str(tmp_path / 'latest_net_G.pth')
    jpth.save_pth(path, jnet, params)
    tpth.load_pth(path, tnet)
    ref = from_jax_params(tnet, params)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, ref[k]), k
    # and the port writes the same keys back
    back = str(tmp_path / 'port_net_G.pth')
    tpth.save_pth(back, tnet)
    assert set(torch.load(back, weights_only=True)) == set(
        torch.load(path, weights_only=True))


def test_loaded_fcgan_forward_matches_jax():
    """Layout conversion carries numerics: the JAX fcgan and the port's,
    on the same weights and noise.  Tolerance 1e-4: f32 convT sums and
    batch statistics reduced in another order."""
    jnet, params, tnet = build_pair('fcgan', seed=2)
    tnet.load_state_dict(from_jax_params(tnet, params), strict=True)
    noise = rand((1, 2, 2, 4), 3)
    y = jnet.apply(params, jnp.asarray(noise), jnn.Ctx(jax.random.PRNGKey(0)))
    with torch.no_grad():
        ours = tnet(nchw(noise))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


def test_strict_load_rejects_wrong_width(tmp_path):
    jnet, params, _ = build_pair('fcgan')
    path = str(tmp_path / 'g.pth')
    jpth.save_pth(path, jnet, params)
    wider = tnn.define_G(2, 0, 16, 'fcgan', 'instance', False, n_layers_G=3,
                         use_fcn=True, noise_nc=4)
    with pytest.raises(RuntimeError):
        tpth.load_pth(path, wider)
