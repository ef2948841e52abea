"""The recipes fed by the unaligned dataset, `--model cgan2` and `--model
cgan_causal`, of the port on the CPU against the JAX package's, and the
unaligned loader against the JAX package's.

One f32 step each, through tests/test_torch_cgan_cycle.py's harness and
tolerances (narrow geometry, the JAX step's key schedule replayed, a pool
that starts full):
  * cgan2 (unet_128 G, a 2-scale D bank) with --train_G_on_fake_fake_pair
    and --pool_reject_prob 0.3: its pool decisions come from the port's
    stage_rows with the JAX draws, so the rejection probability is the
    port's own;
  * cgan_causal with --really_CausalGAN: the Anti-Labeler's Adam steps on
    zero gradients, so LG leaves the step as it entered, in both packages.
Each writes its .pth files, which load into the JAX package's utils/pth.py,
and loads the JAX step's parameters with --continue_train (strict).

The loader: <dataroot>/trainA (3 label + image PNGs) and trainB (2
fake-label PNGs) at loadSize 144, fineSize 128, flips on, one shuffled
epoch of each package from one seed: the same A and B arrays, the same
paths, B indexed independently of A modulo its size; and the batch's
input_fake_A is B's label channels.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu.data import CreateDataLoader as JCreateDataLoader
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch.data import (
    CreateDataLoader as TCreateDataLoader)
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_cgan_cycle import (D1, G_NETS, assert_pth_both_ways,
                                   assert_step_matches, batch, flags,
                                   jax_vs_port_step, port_modules)
from test_torch_layout import one_thread  # noqa: F401

G_D = ['--which_model_netG', 'unet_128', '--ngf', '4',
       '--which_model_netD', 'n_layers', '--n_layers_D', '1', '2',
       '--ndf', '4', '--scale_factor', '1', '2', '--lambda_D', '0.5', '0.4']
CASES = {
    'cgan2': (G_D + ['--train_G_on_fake_fake_pair', '--pool_reject_prob',
                     '0.3'],
              # noise, forward key; D's pool
              {'noise': [0], 'fkey': [1], 'pool': [2]}, ['D', None],
              ['fake']),
    'cgan_causal': (G_NETS + D1 + ['--really_CausalGAN'],
                    # noise1, noise2, forward key; D1's pool (LG's key 4
                    # draws nothing)
                    {'noise': [0, 1], 'fkey': [2], 'pool': [3]},
                    ['D1', 'LG', None], ['pool1']),
}


@pytest.mark.parametrize('model', list(CASES))
def test_step_matches_jax(tmp_path, model):
    extra, schedule, updates, pools = CASES[model]
    f = flags(str(tmp_path), model, model, 'unaligned', *extra)
    r = jax_vs_port_step(f, batch(unaligned=True), schedule, updates,
                         full_pools=pools)
    assert_step_matches(r)
    tm = r['port']
    if model == 'cgan2':
        assert tm.pool_rejects == {'fake': 0.3}
        assert set(tm._taps) == {'fake_B_from_real_A', 'fake_B_from_fake_A'}
    else:
        init = from_jax_params(tm.netLG, r['init']['LG'])
        after = from_jax_params(tm.netLG, r['params']['LG'])
        for name, p in tm.netLG.named_parameters():
            assert torch.equal(p.detach(), init[name]), name
            assert torch.equal(after[name], init[name]), name
        assert float(tm.optLG.state[next(tm.netLG.parameters())]['step']) \
            == 1
    assert_pth_both_ways(r, tmp_path, f)


def test_cgan2_needs_unaligned(tmp_path):
    with pytest.raises(ValueError, match='unaligned'):
        tcreate(TTrainOptions().parse(flags(
            str(tmp_path), 'c', 'cgan2', 'single', *G_D) + ['--gpu_ids',
                                                          '-1']))


@pytest.fixture(scope='module')
def unaligned_root(tmp_path_factory):
    d = tmp_path_factory.mktemp('unaligned')
    rng = np.random.RandomState(0)
    for side, n in (('trainA', 3), ('trainB', 2)):
        os.makedirs(d / side)
        for i in range(n):
            a = np.zeros((144, 144, 3), np.uint8)
            a[..., 0] = (rng.rand(144, 144) > 0.6) * 255
            a[..., 1] = (rng.rand(144, 144) > 0.7) * 255
            a[..., 2] = rng.randint(0, 255, (144, 144))
            Image.fromarray(a).save(str(d / side / ('%s%d.png'
                                                    % (side[-1], i))))
    return str(d)


def test_unaligned_loader_matches_jax(unaligned_root, tmp_path):
    f = ['--dataroot', unaligned_root, '--name', 'u', '--model', 'cgan2',
         '--dataset_mode', 'unaligned', '--loadSize', '144', '--fineSize',
         '128', '--batchSize', '1', '--manualSeed', '3', '--nThreads', '1',
         '--checkpoints_dir', str(tmp_path), '--which_channel', 'rg_b']
    ours = list(TCreateDataLoader(TTrainOptions().parse(f)).load_data())
    ref = list(JCreateDataLoader(JTrainOptions().parse(f)).load_data())
    assert len(ours) == len(ref) == 3
    b_paths = sorted(os.path.join(unaligned_root, 'trainB', n)
                     for n in os.listdir(os.path.join(unaligned_root,
                                                      'trainB')))
    a_seen = []
    for o, r in zip(ours, ref):
        assert o['A_paths'] == r['A_paths'] and o['B_paths'] == r['B_paths']
        np.testing.assert_array_equal(o['A'], r['A'])
        np.testing.assert_array_equal(o['B'], r['B'])
        a = o['A_paths'][0]
        index = int(os.path.basename(a)[1])
        assert o['B_paths'][0] == b_paths[index % 2]
        a_seen.append(a)
    assert len(set(a_seen)) == 3          # each A once an epoch
    tm = tcreate(TTrainOptions().parse(
        f + G_D + ['--gpu_ids', '-1', '--pool_size', '0', '--no_dropout']))
    tm.set_input(ours[0])
    assert torch.equal(tm.input_fake_A,
                       torch.from_numpy(ours[0]['B'][..., :2]).permute(
                           0, 3, 1, 2))
    assert torch.equal(tm.input_B, torch.from_numpy(
        ours[0]['A'][..., 2:]).permute(0, 3, 1, 2))
    assert tm.get_image_paths() == ours[0]['A_paths']
    assert [n for n, _, _ in port_modules(tm)] == ['G', 'D', 'D']
