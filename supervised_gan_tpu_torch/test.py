"""Sampling entry point: the counterpart of the JAX package's test.py.

    python -m supervised_gan_tpu_torch.test --dataroot ./datasets/null \\
        --name dsgan_model --model twostage_cycle <architecture flags> \\
        --how_many N [--gpu_ids -1 for the CPU]
    python -m supervised_gan_tpu_torch.test --dataroot <labels> \\
        --name cgan_model --model cgan <architecture flags> --how_many N

The unconditional models (fcgan, twostage_cycle) draw --how_many samples
and write them with synthetic ``%04d.png`` names; the conditional ones
(cgan) iterate the dataset in order, up to --how_many images, each named
after its input.  Both write under results/<name>/<phase>_<which_epoch>/
(index.html + images/), the layout the MATLAB evaluation tower consumes.
TF32 is off (models/base.py `disable_tf32`); --no_pallas runs every conv
and norm site on its PyTorch library call.

It takes the parallel flags (--data_mesh, --spatial_mesh, --dcn_*) and runs
one unsharded process all the same, as the JAX package does: only training
is sharded.
"""

import os
import time

import torch

from .data import CreateDataLoader
from .options import TestOptions
from .models import create_model
from .models.base import disable_tf32
from .utils.visualizer import Visualizer
from .utils import html


def main(args=None):
    """Run the sampler; returns {'web_dir', 'samples', 'nonfinite',
    'loop_seconds', 'sample_seconds', 'write_seconds'}: nonfinite counts
    samples with a non-finite output, loop_seconds times the sampling loop,
    split into drawing the samples (up to their finiteness check, which
    waits for the device) and converting and writing the images."""
    disable_tf32()
    opt = TestOptions().parse(args)
    opt.nThreads = 1
    opt.batchSize = 1
    opt.serial_batches = True
    opt.no_flip = True
    opt.no_rotate = True

    model = create_model(opt)
    visualizer = Visualizer(opt)

    web_dir = os.path.join(opt.results_dir, opt.name,
                           '%s_%s' % (opt.phase, opt.which_epoch))
    webpage = html.HTML(web_dir, 'Experiment = %s, Phase = %s, Epoch = %s'
                        % (opt.name, opt.phase, opt.which_epoch))

    conditional = opt.model.startswith('cgan')
    if conditional:
        inputs = CreateDataLoader(opt).load_data()
    else:
        inputs = [None] * opt.how_many
    nonfinite = samples = 0
    sample_seconds = write_seconds = 0.0
    for i, data in enumerate(inputs):
        if i >= opt.how_many:
            break
        t0 = time.perf_counter()
        if conditional:
            model.set_input(data)
        model.test()
        if not all(bool(torch.isfinite(t).all()) for t in model.outputs()):
            nonfinite += 1
        t1 = time.perf_counter()
        visuals = model.get_current_visuals(
            save_as_single_image=opt.save_as_single_image)
        if conditional:
            img_path = model.get_image_paths()
            print('process image... %s' % img_path)
        else:
            img_path = ['%04d.png' % (i + 1)]
            print('produce image... %s' % img_path)
        visualizer.save_images(webpage, visuals, img_path)
        sample_seconds += t1 - t0
        write_seconds += time.perf_counter() - t1
        samples += 1
    if nonfinite:
        print('WARNING: %d of %d samples have non-finite values'
              % (nonfinite, samples))

    webpage.save()
    return {'web_dir': web_dir, 'samples': samples,
            'nonfinite': nonfinite,
            'loop_seconds': sample_seconds + write_seconds,
            'sample_seconds': sample_seconds, 'write_seconds': write_seconds}


if __name__ == '__main__':
    main()
