"""Sampling driver: the unconditional branch of the JAX package's test.py.

    python -m supervised_gan_tpu_torch.test --dataroot ./datasets/null \\
        --name dsgan_model --model twostage_cycle <architecture flags> \\
        --how_many N [--gpu_ids -1 for the CPU]

Draws --how_many samples and writes them with synthetic ``%04d.png`` names
under results/<name>/<phase>_<which_epoch>/ (index.html + images/), the
layout the MATLAB evaluation tower consumes.  The conditional models
(cgan*) iterate a dataset and come with the data pipeline.
"""

import os
import time

import torch

from .options import TestOptions
from .models import create_model
from .utils.visualizer import Visualizer
from .utils import html


def main(args=None):
    """Run the sampler; returns {'web_dir', 'samples', 'nonfinite',
    'loop_seconds', 'sample_seconds', 'write_seconds'}: nonfinite counts
    samples with a non-finite output, loop_seconds times the sampling loop,
    split into drawing the samples (up to their finiteness check, which
    waits for the device) and converting and writing the images."""
    opt = TestOptions().parse(args)
    opt.nThreads = 1
    opt.batchSize = 1
    opt.serial_batches = True
    opt.no_flip = True
    opt.no_rotate = True
    if opt.model.startswith('cgan'):
        raise NotImplementedError('the conditional sampler (--model %s) needs '
                                  'the data pipeline, not yet ported'
                                  % opt.model)

    model = create_model(opt)
    visualizer = Visualizer(opt)

    web_dir = os.path.join(opt.results_dir, opt.name,
                           '%s_%s' % (opt.phase, opt.which_epoch))
    webpage = html.HTML(web_dir, 'Experiment = %s, Phase = %s, Epoch = %s'
                        % (opt.name, opt.phase, opt.which_epoch))

    nonfinite = 0
    sample_seconds = write_seconds = 0.0
    for i in range(opt.how_many):
        t0 = time.perf_counter()
        model.test()
        if not all(bool(torch.isfinite(t).all()) for t in model.outputs()):
            nonfinite += 1
        t1 = time.perf_counter()
        visuals = model.get_current_visuals(
            save_as_single_image=opt.save_as_single_image)
        img_path = ['%04d.png' % (i + 1)]
        print('produce image... %s' % img_path)
        visualizer.save_images(webpage, visuals, img_path)
        sample_seconds += t1 - t0
        write_seconds += time.perf_counter() - t1
    if nonfinite:
        print('WARNING: %d of %d samples have non-finite values'
              % (nonfinite, opt.how_many))

    webpage.save()
    return {'web_dir': web_dir, 'samples': opt.how_many,
            'nonfinite': nonfinite,
            'loop_seconds': sample_seconds + write_seconds,
            'sample_seconds': sample_seconds, 'write_seconds': write_seconds}


if __name__ == '__main__':
    main()
