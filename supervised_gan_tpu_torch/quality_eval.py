"""The downstream-quality gate, driven through the port's entry points: the
counterpart of tools/quality_eval.py.

The reference's entire evaluation gate is segmentation quality after the
generative pipeline (reference test_ss.py:46-51, segm_model.py:299-341):
train DSGAN -> sample (label, image) pairs -> train a segmentation net on
the GENERATED pairs -> evaluate RandScore / meanIU / CE on the held-out
REAL set.  This driver runs that loop on a synthetic VNC-style set through
``python -m supervised_gan_tpu_torch.{train,test,train_ss,test_ss}``, with
the same protocol, at the same reduced recipe scale:

  * ours: the GAN's sampled pairs as the segmenter's training set;
  * the real-pairs bound: the same segmentation protocol trained on the
    REAL train split (what a perfect generator would enable);
  * with ``--negative_control``, the label-shuffled control: the sampled
    pairs with every image (B) deranged across them, so that each label
    meets a wrong image; a sensitive gate ranks bound >= ours >> control.

Run (on the card; ``--gpu_ids -1`` runs every driver on the CPU):

  python -m supervised_gan_tpu_torch.quality_eval --px 512 --ngf 16 \\
      --train_n 32 --samples 64 --epochs_gan 50 --epochs_ss 20 \\
      --negative_control

Each driver runs as its own process from the checkout's root, its output in
``<work>/<tag>.log``; the data, checkpoints and samples live under
``--work`` (default ``quality_torch`` in the temporary directory, emptied
first), and the JSON goes to ``--out`` (default ``<work>/quality.json``).
"""

import argparse
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
from PIL import Image

from .data.transforms import load_rgb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_args(px=128, ngf=8, lr=2e-4):
    """DSGAN + segmentation CLI arg lists for a square ``px`` geometry
    (reduced README recipe: fcgan G1 -> px/2 label -> bilinear x2 -> CRN
    G2; unet F2; 1-scale D1/D2).  fcgan upsamples noiseSize*2^(n+1), so
    n_layers_G1 = log2(px)-4 puts the G1 label at px/2 with noiseSize 4
    (px=128 -> n3; px=512 -> n5, matching bench.py).  CRN consumes a
    pool64 label, noiseSize2 = px//64.  D depth scales with resolution (2
    layers at 128px, 3 above)."""
    n_g1 = int(math.log2(px)) - 4
    n_d = 2 if px <= 128 else 3
    gan_net = [
        '--model', 'twostage_cycle', '--which_direction', 'AtoB',
        '--dataset_mode', 'single', '--loadSize', str(px),
        '--fineSize', str(px),
        '--transform_1to2', 'bilinear_2', '--which_channel', 'rg_b',
        '--which_model_netG1', 'fcgan', '--n_layers_G1', str(n_g1),
        '--ngf1', str(ngf), '--noiseSize1', '4', '--noise_nc1', '8',
        '--which_model_netG2', 'crn', '--ngf2', str(ngf),
        '--upsample_mode2', 'bilinear', '--n_layers_CRN_block2', '2',
        '--which_model_netF2', 'unet_128', '--nff2', str(ngf),
        '--noiseSize2', str(px // 64), '--noise_nc2', '8',
        '--norm', 'instance', '--no_dropout1', '--manualSeed', '0',
    ]
    gan_train = gan_net + [
        '--batchSize', '1',
        '--which_model_netD1', 'n_layers', '--n_layers_D1', str(n_d),
        '--ndf1', str(ngf), '--scale_factor1', '1', '--lambda_D1', '0.5',
        '--which_model_netD2', 'n_layers', '--n_layers_D2', str(n_d),
        '--ndf2', str(ngf), '--scale_factor2', '1', '--lambda_D2', '0.5',
        '--lambda_A', '10', '--lambda_B', '10', '--lambda_A_cycle', '5',
        '--lambda_fake_cycle', '1', '--no_lsgan1', '--no_lsgan2',
        '--GAN_losses_D2', 'real_fake', '--GAN_losses_G2', 'real_fake',
        '--n_update_G', '1', '--pool_size', '16', '--lr1', repr(lr),
        '--lr2', repr(lr), '--print_freq', '64', '--display_id', '0',
        '--abort_on_nan', '--cache_data',
    ]
    ss_net = [
        '--model', 'segmentation', '--which_direction', 'AtoB',
        '--dataset_mode', 'single', '--loadSize', str(px),
        '--fineSize', str(px),
        '--batchSize', '1', '--which_channel', 'b_rg',
        '--which_model_netG', 'unet_128', '--ngf', str(ngf),
        '--noise_nc', '4', '--noiseSize', '4', '--norm', 'instance',
        '--which_metric', 'RandScore', 'meanIU',
        '--which_model_netD', 'None', '--manualSeed', '0',
        '--display_id', '0',
    ]
    ss_train = ss_net + ['--lambda_A', '1', '--print_freq', '64',
                         '--cache_data']
    return gan_net, gan_train, ss_net, ss_train


def make_dataset(root, seed=0, px=128, counts=(8, 4, 8)):
    """VNC-style synthetic at ``px``: R,G sparse binary label blobs, B
    image correlated with the labels (so segmentation has signal to
    learn).  Blob count/radius scale with area so density matches the
    128px original."""
    rng = np.random.RandomState(seed)
    s = px // 128
    for phase, n in zip(('train', 'val', 'test'), counts):
        d = os.path.join(root, phase)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            r = np.zeros((px, px), np.float32)
            for _ in range(6 * s * s):             # blobby foreground
                cy, cx = rng.randint(10 * s, px - 10 * s, 2)
                yy, xx = np.ogrid[:px, :px]
                r += ((yy - cy) ** 2 + (xx - cx) ** 2
                      < rng.randint(5 * s, 14 * s) ** 2).astype(np.float32)
            r = (r > 0).astype(np.float32)
            g = 1.0 - r
            img = (0.7 * r + 0.15 * rng.rand(px, px)
                   + 0.1 * np.roll(r, 3 * s, 0))
            arr = np.stack([r, g, np.clip(img, 0, 1)], -1)
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                os.path.join(d, '%03d.png' % i))


def _hard_sample(rng, px):
    """One (px,px,3) hard VNC-style sample in [0,1].  R = foreground
    (thin cell membranes + mitochondria), G = background, B = EM-like
    image with per-cell albedo, band-limited texture, sensor noise,
    deliberately faint mitochondria and unlabeled dark distractor
    specks -- built so the real-pairs segmentation bound lands well
    below 1.0."""
    import scipy.ndimage as ndi
    s = px / 256.0
    yy, xx = np.mgrid[0:px, 0:px].astype(np.float32)

    # Voronoi cells: nearest/second-nearest center distances
    ncell = max(8, int(round(px * px / (48.0 * 48.0 * s * s))))
    cy = rng.uniform(0, px, ncell).astype(np.float32)
    cx = rng.uniform(0, px, ncell).astype(np.float32)
    best = np.full((px, px), np.inf, np.float32)
    second = np.full((px, px), np.inf, np.float32)
    idx = np.zeros((px, px), np.int32)
    for k in range(ncell):
        dd = (yy - cy[k]) ** 2 + (xx - cx[k]) ** 2
        closer = dd < best
        second = np.where(closer, best, np.minimum(second, dd))
        idx = np.where(closer, k, idx)
        best = np.where(closer, dd, best)

    # thin membranes at cell boundaries (1-3 px at 256, scale-invariant)
    width = (0.6 + 0.6 * rng.rand()) * s
    memb = (np.sqrt(second) - np.sqrt(best)) < 2.0 * width

    # mitochondria: filled ellipses; ~25% deliberately faint
    mito = np.zeros((px, px), bool)
    depth = np.zeros((px, px), np.float32)
    # counts are scale-invariant: feature SIZES already scale with s, so
    # a fixed count keeps area fractions constant across px
    for _ in range(rng.randint(8, 17)):
        my = rng.uniform(8 * s, px - 8 * s)
        mx = rng.uniform(8 * s, px - 8 * s)
        a, b = rng.uniform(3 * s, 9 * s, 2)
        th = rng.uniform(0, np.pi)
        Y, X = yy - my, xx - mx
        u = (np.cos(th) * X + np.sin(th) * Y) / a
        v = (-np.sin(th) * X + np.cos(th) * Y) / b
        m = u * u + v * v < 1
        mito |= m
        d = (0.15 + 0.40 * rng.rand()) if rng.rand() < 0.25 \
            else (0.55 + 0.25 * rng.rand())
        depth = np.maximum(depth, m * np.float32(d))

    fg = memb | mito

    # EM-like image
    albedo = (0.55 + 0.25 * rng.rand(ncell)).astype(np.float32)
    img = albedo[idx]
    t = max(4, int(16 * s))
    low = rng.rand(px // t + 2, px // t + 2).astype(np.float32)
    img = img + 0.12 * (np.kron(low, np.ones((t, t),
                                             np.float32))[:px, :px] - 0.5)
    img = img * (1.0 - 0.55 * memb)
    img = img * (1.0 - depth)
    # unlabeled dark specks -- distractors that resemble small mito
    for _ in range(24):
        sy = rng.randint(2, px - 2)
        sx = rng.randint(2, px - 2)
        r0 = max(1, int(round(rng.uniform(1, 2) * s)))
        img[max(0, sy - r0):sy + r0, max(0, sx - r0):sx + r0] *= 0.55
    img = ndi.gaussian_filter(img, 0.5 * s)
    img = img + 0.10 * rng.randn(px, px).astype(np.float32)

    r = fg.astype(np.float32)
    return np.stack([r, 1.0 - r, np.clip(img, 0, 1)], -1)


def make_dataset_hard(root, seed=0, px=256, counts=(20, 4, 8)):
    """Hard VNC-style synthetic dataset (see _hard_sample).  Same channel
    packing as make_dataset: R,G binary 2-class labels, B image."""
    rng = np.random.RandomState(seed)
    for phase, n in zip(('train', 'val', 'test'), counts):
        d = os.path.join(root, phase)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = _hard_sample(rng, px)
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                os.path.join(d, '%03d.png' % i))


def make_label_shuffled(src_train, dst_train, seed=0):
    """Negative control: derange the image (B) channel across the
    generated pairs so every label is paired with a WRONG image.  A
    sensitive downstream gate must score this far below the GAN row."""
    paths = sorted(glob.glob(os.path.join(src_train, '*.png')))
    if len(paths) < 2:
        raise ValueError('need >= 2 generated pairs to shuffle, found %d in '
                         '%s' % (len(paths), src_train))
    arrs = [np.asarray(load_rgb(p)) for p in paths]
    n = len(arrs)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    while np.any(perm == np.arange(n)):
        perm = rng.permutation(n)
    os.makedirs(dst_train, exist_ok=True)
    for i, p in enumerate(paths):
        a = arrs[i].copy()
        a[..., 2] = arrs[perm[i]][..., 2]
        Image.fromarray(a).save(os.path.join(dst_train, os.path.basename(p)))


def parse_ss_metrics(out):
    """RandScore, meanIU and the cross entropy's mean and std from
    test_ss's output."""
    m = {}
    for k in ('RandScore', 'meanIU'):
        hit = re.search(r'%s: ([0-9.eE+-]+)' % k, out)
        if hit:
            m[k] = float(hit.group(1))
    hit = re.search(r'cross entropy loss: mean ([0-9.eE+-]+), '
                    r'std ([0-9.eE+-]+)', out)
    if hit:
        m['CE_mean'] = float(hit.group(1))
        m['CE_std'] = float(hit.group(2))
    return m


def run_process(driver, args, log):
    """``python -m supervised_gan_tpu_torch.<driver> <args>`` from the
    checkout's root, its output to the file ``log``; returns its exit
    code."""
    with open(log, 'w') as f:
        return subprocess.call(
            [sys.executable, '-m', 'supervised_gan_tpu_torch.' + driver]
            + args, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)


class Gate:
    """The gate's runs under one work directory, every driver on the
    device ``gpu_ids`` names, each run by ``runner(driver, args, log)``
    (its exit code; by default a process of its own).  ``seconds`` keeps
    each run's wall time by tag."""

    def __init__(self, work, gpu_ids='0', runner=run_process):
        self.work = work
        self.gpu_ids = gpu_ids
        self.runner = runner
        self.real = os.path.join(work, 'real')
        self.gen = os.path.join(work, 'gen')
        self.ckpt = os.path.join(work, 'ckpt')
        self.results = os.path.join(work, 'results')
        self.seconds = {}

    def run(self, driver, args, tag):
        """One driver run, its output in ``<work>/<tag>.log``; raises if it
        exits non-zero."""
        log = os.path.join(self.work, tag + '.log')
        t0 = time.time()
        rc = self.runner(driver, ['--gpu_ids', self.gpu_ids] + args, log)
        self.seconds[tag] = time.time() - t0
        with open(log) as f:
            out = f.read()
        print('[%s] rc=%d  %.1fs  (%s)' % (tag, rc, self.seconds[tag], log),
              flush=True)
        if rc != 0:
            print(out[-3000:])
            raise RuntimeError('%s failed (exit %d); its output: %s'
                               % (tag, rc, log))
        return out

    def segment(self, dataroot, name, epochs_ss, ss_net, ss_train, tag):
        """train_ss on ``dataroot``'s train and val splits, then test_ss on
        the real test split; returns test_ss's metrics."""
        self.run('train_ss', [
            '--dataroot', dataroot, '--name', name,
            '--checkpoints_dir', self.ckpt, '--niter', str(epochs_ss),
            '--niter_decay', str(epochs_ss),
            '--save_epoch_freq', str(2 * epochs_ss)] + ss_train,
            tag + '_train')
        out = self.run('test_ss', [
            '--dataroot', self.real, '--name', name,
            '--checkpoints_dir', self.ckpt, '--results_dir', self.results,
            '--how_many', '999', '--which_epoch', 'latest',
            '--phase', 'test'] + ss_net, tag + '_test')
        return parse_ss_metrics(out)

    def pipeline(self, epochs_gan, epochs_ss, samples, gan_net, gan_train,
                 ss_net, ss_train, negative_control=False):
        """Train the GAN on the real set, sample ``samples`` pairs, and run
        the segmentation protocol on them, on the real pairs (the bound)
        and, with ``negative_control``, on the label-shuffled pairs.
        Returns (ours, bound, pairs sampled, control or None)."""
        name = 'q_gan'
        out = self.run('train', [
            '--dataroot', self.real, '--name', name,
            '--checkpoints_dir', self.ckpt, '--niter', str(epochs_gan),
            '--niter_decay', str(epochs_gan),
            '--save_epoch_freq', str(2 * epochs_gan)] + gan_train,
            'gan_train')
        # fail fast on adversarial divergence: sampling a NaN'd generator
        # silently yields all-black pairs and a meaningless downstream number
        tail_losses = [l for l in out.splitlines() if 'G2_GAN' in l][-3:]
        if any('nan' in l or 'inf' in l for l in tail_losses):
            raise RuntimeError('GAN training diverged -- lower --lr '
                               '(tail: %s)' % (tail_losses[-1] if tail_losses
                                               else '?'))
        self.run('test', [
            '--dataroot', self.real, '--name', name,
            '--checkpoints_dir', self.ckpt, '--results_dir', self.results,
            '--how_many', str(samples), '--save_as_single_image'] + gan_net,
            'gan_sample')

        # generated pairs -> train split; real val images -> val split
        os.makedirs(os.path.join(self.gen, 'train'), exist_ok=True)
        imgs = sorted(glob.glob(os.path.join(
            self.results, name, 'test_latest', 'images', '*AB*.png')))
        if not imgs:
            raise RuntimeError('the sampler wrote no *AB*.png pair under %s'
                               % self.results)
        for p in imgs:
            shutil.copy(p, os.path.join(self.gen, 'train',
                                        os.path.basename(p)))
        shutil.copytree(os.path.join(self.real, 'val'),
                        os.path.join(self.gen, 'val'), dirs_exist_ok=True)
        ours = self.segment(self.gen, 'q_ss', epochs_ss, ss_net, ss_train,
                            'ss')
        # upper bound: the same segmentation protocol trained on the REAL
        # train split (what a perfect generator would enable)
        bound = self.segment(self.real, 'q_ss_ub', epochs_ss, ss_net,
                             ss_train, 'ss_ub')
        # negative control: the same protocol on label-shuffled generated
        # pairs -- a sensitive gate must rank real-bound >= GAN >> shuffled
        neg = None
        if negative_control:
            gen_neg = self.gen + '_neg'
            make_label_shuffled(os.path.join(self.gen, 'train'),
                                os.path.join(gen_neg, 'train'))
            shutil.copytree(os.path.join(self.real, 'val'),
                            os.path.join(gen_neg, 'val'), dirs_exist_ok=True)
            neg = self.segment(gen_neg, 'q_ss_neg', epochs_ss, ss_net,
                               ss_train, 'ss_neg')
        return ours, bound, len(imgs), neg


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--epochs_gan', type=int, default=30)
    ap.add_argument('--epochs_ss', type=int, default=20)
    ap.add_argument('--samples', type=int, default=32)
    ap.add_argument('--gpu_ids', default='0',
                    help='passed to every driver: the card, or -1 for the '
                         'CPU')
    ap.add_argument('--px', type=int, default=128)
    ap.add_argument('--ngf', type=int, default=8)
    ap.add_argument('--train_n', type=int, default=8)
    ap.add_argument('--val_n', type=int, default=4)
    ap.add_argument('--test_n', type=int, default=8)
    ap.add_argument('--lr', type=float, default=2e-4,
                    help='GAN lr; 2e-4 matches the reference recipe but '
                         'can diverge on small synthetic sets at >=256px')
    ap.add_argument('--work', default=os.path.join(tempfile.gettempdir(),
                                                   'quality_torch'),
                    help='work directory, emptied first')
    ap.add_argument('--out', default=None,
                    help='the JSON result (default <work>/quality.json)')
    ap.add_argument('--dataset', choices=('easy', 'hard'), default='easy',
                    help='hard: thin membranes + faint mito + noise so the '
                         'real-pairs bound lands well below 1.0')
    ap.add_argument('--negative_control', action='store_true',
                    help='add a label-shuffled-pairs row (gate sensitivity)')
    return ap


def evaluate(args, runner=run_process):
    """The gate for parsed ``args``; returns (its JSON record, the Gate,
    whose ``seconds`` time each driver run)."""
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work, exist_ok=True)
    gate = Gate(args.work, args.gpu_ids, runner)
    maker = make_dataset_hard if args.dataset == 'hard' else make_dataset
    maker(gate.real, px=args.px,
          counts=(args.train_n, args.val_n, args.test_n))
    arg_lists = build_args(args.px, args.ngf, args.lr)

    t0 = time.time()
    ours, upper, n_gen, neg = gate.pipeline(
        args.epochs_gan, args.epochs_ss, args.samples, *arg_lists,
        negative_control=args.negative_control)
    t_ours = time.time() - t0
    print('ours:', ours, flush=True)
    print('upper bound (real pairs):', upper, flush=True)
    if neg is not None:
        print('negative control (label-shuffled pairs):', neg, flush=True)

    result = {
        'pipeline': 'train DSGAN -> test sample -> train_ss on generated '
                    'pairs -> test_ss on real held-out set '
                    '(reference test_ss.py:46-51 gate)',
        'scale': {'px': args.px, 'ngf': args.ngf, 'lr': args.lr,
                  'epochs_gan': 2 * args.epochs_gan,
                  'epochs_ss': 2 * args.epochs_ss,
                  'train_images': args.train_n, 'generated_pairs': n_gen,
                  'test_images': args.test_n, 'dataset': args.dataset},
        'ours': ours,
        'real_pairs_upper_bound': upper,
        'negative_control_label_shuffled': neg,
        'ours_platform': 'cpu' if args.gpu_ids == '-1' else 'gpu',
        'ours_wall_sec': round(t_ours, 1),
        'note': 'metrics computed by supervised_gan_tpu_torch/utils/'
                'metrics.py in test_ss; higher RandScore/meanIU better, '
                'lower CE better',
    }
    return result, gate


def main(argv=None):
    args = parser().parse_args(argv)
    result, _ = evaluate(args)
    out_path = args.out or os.path.join(args.work, 'quality.json')
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
