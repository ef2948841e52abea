"""Segmentation evaluation: the counterpart of the JAX package's test_ss.py
(reference test_ss.py).

    python -m supervised_gan_tpu_torch.test_ss --dataroot <dir> \\
        --name <name> --model segmentation <architecture flags> \\
        --which_metric RandScore meanIU [--which_epoch best] \\
        [--gpu_ids -1 for the CPU]

Runs every image of <dataroot>/<phase> in order, unaugmented: the
accuracies (--which_metric) over the whole set and each image's cross
entropy, written with its image, label and prediction under
results/<name>/<phase>_<which_epoch>/; prints the accuracies and the
cross entropy's mean and std.  TF32 is off (models/base.py
`disable_tf32`).

It takes the parallel flags (--data_mesh, --spatial_mesh, --dcn_*) and runs
one unsharded process all the same, as the JAX package does: only training
is sharded.
"""

import os
import time

import numpy as np
import torch

from .data import CreateDataLoader
from .models import create_model
from .models.base import disable_tf32
from .options import TestOptions
from .utils import html
from .utils.visualizer import Visualizer


def main(args=None):
    """Evaluate; returns {'images', 'accs', 'ce_mean', 'ce_std', 'web_dir',
    'loop_seconds', 'test_seconds'}: test_seconds times the forwards and
    their metrics (to a device synchronization), loop_seconds the whole
    loop with the images written."""
    disable_tf32()
    opt = TestOptions().parse(args)
    opt.nThreads = 1
    opt.batchSize = 1
    opt.serial_batches = True
    opt.no_flip = True
    opt.no_rotate = True

    data_loader = CreateDataLoader(opt)
    dataset = data_loader.load_data()
    print('#testing images = %d' % len(data_loader))
    model = create_model(opt)
    cuda = model.device.type == 'cuda'
    visualizer = Visualizer(opt)

    web_dir = os.path.join(opt.results_dir, opt.name,
                           '%s_%s' % (opt.phase, opt.which_epoch))
    webpage = html.HTML(web_dir, 'Experiment = %s, Phase = %s, Epoch = %s'
                        % (opt.name, opt.phase, opt.which_epoch))

    model.reset_accs()
    ce_loss = []
    test_seconds = 0.0
    t_loop = time.perf_counter()
    for data in dataset:
        t0 = time.perf_counter()
        model.set_input(data)
        model.test()
        model.compute_cross_entropy_loss()
        model.accum_accs()
        errs = model.get_current_errors()
        if cuda:
            torch.cuda.synchronize(model.device)
        test_seconds += time.perf_counter() - t0
        ce_loss.append(errs['G_CE'])
        visuals = model.get_current_visuals()
        img_path = model.get_image_paths()
        print('process image... %s' % img_path)
        visualizer.save_images(webpage, visuals, img_path)
    loop_seconds = time.perf_counter() - t_loop

    accs = model.get_current_accs()
    ce_loss = np.array(ce_loss)
    print('Segmentation results:')
    for key in accs.keys():
        print('{}: {}'.format(key, accs[key]))
    print('cross entropy loss: mean {}, std {}'.format(
        np.mean(ce_loss), np.std(ce_loss)))
    webpage.save()
    return {'images': len(ce_loss),
            'accs': {k: float(v) for k, v in accs.items()},
            'ce_mean': float(np.mean(ce_loss)),
            'ce_std': float(np.std(ce_loss)), 'web_dir': web_dir,
            'loop_seconds': loop_seconds, 'test_seconds': test_seconds}


if __name__ == '__main__':
    main()
