"""Latent reconstruction entry point: the counterpart of the JAX package's
recon.py (reference recon.py).

    python -m supervised_gan_tpu_torch.recon --dataroot <dir> --name <fcgan \\
        run> --model fcgan <architecture flags> --how_many N \\
        [--gpu_ids -1 for the CPU]

For each of the first --how_many images of <dataroot>/<phase>, in order,
the fcgan generator's noise is fitted to it by L-BFGS
(models/fcgan.py reconstruction); its reconstruction and the image go into
results/<name>/<phase>_<which_epoch>/ (index.html + images/).  The last
line gives the BCE of the reconstructions and the N(0, I) negative
log-likelihood of the fitted and of the starting noises, mean and std over
the images.  TF32 is off (models/base.py `disable_tf32`).

It takes the parallel flags (--data_mesh, --spatial_mesh, --dcn_*) and runs
one unsharded process all the same, as the JAX package does: only training
is sharded.
"""

import os
import time

import numpy as np

from .data import CreateDataLoader
from .models import create_model
from .models.base import disable_tf32
from .nn.losses import bce_loss
from .options import TestOptions
from .utils import html
from .utils.visualizer import Visualizer


def main(args=None):
    """Run the reconstruction; returns {'web_dir', 'images', 'bce',
    'bce_init', 'nll', 'nll_init', 'seconds'}: per image (lists) the BCE
    of the fit and of its starting noise, the two negative
    log-likelihoods, and the seconds its reconstruction took."""
    disable_tf32()
    opt = TestOptions().parse(args)
    opt.nThreads = 1
    opt.batchSize = 1
    opt.serial_batches = True
    opt.no_flip = True
    opt.no_rotate = True

    dataset = CreateDataLoader(opt).load_data()
    model = create_model(opt)
    visualizer = Visualizer(opt)
    web_dir = os.path.join(opt.results_dir, opt.name,
                           '%s_%s' % (opt.phase, opt.which_epoch))
    webpage = html.HTML(web_dir, 'Experiment = %s, Phase = %s, Epoch = %s'
                        % (opt.name, opt.phase, opt.which_epoch))

    bce, bce_init, nll, nll_init, seconds = [], [], [], [], []
    for i, data in enumerate(dataset):
        if i >= opt.how_many:
            break
        model.set_input(data)
        print('reconstruct image {}...'.format(i))
        t0 = time.perf_counter()
        d, ll, ll0 = model.reconstruction()
        seconds.append(time.perf_counter() - t0)
        bce.append(d)
        bce_init.append(float(bce_loss((model.fake_init + 1) / 2,
                                       (model.real + 1) / 2)))
        nll.append(ll)
        nll_init.append(ll0)
        visualizer.save_images(webpage, model.get_current_visuals(True),
                               model.get_image_paths())

    webpage.save()
    print('BCE: mean {0:0.4f} std {1:0.4f}; noise: mean {2:0.4f} std {3:0.4f};'
          ' noise init: mean {4:0.4f} std {5:0.4f}'.format(
              np.mean(bce), np.std(bce), np.mean(nll), np.std(nll),
              np.mean(nll_init), np.std(nll_init)))
    return {'web_dir': web_dir, 'images': len(bce), 'bce': bce,
            'bce_init': bce_init, 'nll': nll, 'nll_init': nll_init,
            'seconds': seconds}


if __name__ == '__main__':
    main()
