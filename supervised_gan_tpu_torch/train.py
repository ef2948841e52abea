"""GAN training entry point: the counterpart of the JAX package's train.py
(reference train.py), with the same flags.

    python -m supervised_gan_tpu_torch.train --dataroot <dir> --name <name> \\
        --model twostage_cycle <architecture and loss flags> \\
        [--compute_dtype bfloat16] [--gpu_ids -1 for the CPU]

It owns the epoch / iteration loop, seeding, the display / print / save
cadence and the linear lr decay after --niter epochs; each iteration is one
model.optimize_parameters().  It runs on ``cuda:<first --gpu_ids>``; with no
CUDA device it raises unless --gpu_ids -1 asks for the CPU.
"""

import random
import time

import numpy as np
import torch

from .data import CreateDataLoader
from .models import create_model
from .options import TrainOptions
from .utils.visualizer import Visualizer


def main(args=None):
    """Train; returns {'steps', 'step_seconds'}: the iterations run and
    the wall time of each optimize_parameters() up to a device
    synchronization (the first includes the kernels' build)."""
    opt = TrainOptions().parse(args)
    if opt.manualSeed is None:
        opt.manualSeed = random.randint(1, 10000)
    print('Random Seed: ', opt.manualSeed)
    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)

    data_loader = CreateDataLoader(opt)
    dataset = data_loader.load_data()
    dataset_size = len(data_loader)
    print('#training images = %d' % dataset_size)

    model = create_model(opt)
    visualizer = Visualizer(opt)
    cuda = model.device.type == 'cuda'
    total_steps = 0
    step_seconds = []

    for epoch in range(1, opt.niter + opt.niter_decay + 1):
        epoch_start_time = time.time()
        for data in dataset:
            iter_start_time = time.time()
            total_steps += opt.batchSize
            epoch_iter = total_steps - dataset_size * (epoch - 1)
            model.set_input(data)
            model.optimize_parameters()
            if cuda:
                torch.cuda.synchronize(model.device)
            step_seconds.append(time.time() - iter_start_time)

            if total_steps % opt.display_freq == 0:
                visualizer.display_current_results(
                    model.get_current_visuals(), epoch)

            if total_steps % opt.print_freq == 0:
                errors = model.get_current_errors()
                t = (time.time() - iter_start_time) / opt.batchSize
                visualizer.print_current_errors(epoch, epoch_iter, errors, t)
                if opt.display_id > 0:
                    visualizer.plot_current_errors(
                        epoch, float(epoch_iter) / dataset_size, errors)
                if opt.abort_on_nan and not all(
                        np.isfinite(v) for v in errors.values()):
                    # opt-in (reference semantics: train through NaN); the
                    # last periodic checkpoint is the recovery point
                    raise SystemExit(
                        'abort_on_nan: non-finite metrics at epoch %d '
                        'step %d: %s' % (epoch, total_steps, dict(errors)))

            if total_steps % opt.save_latest_freq == 0:
                print('saving the latest model (epoch %d, total_steps %d)'
                      % (epoch, total_steps))
                model.save('latest')

        if epoch % opt.save_epoch_freq == 0:
            print('saving the model at the end of epoch %d, iters %d'
                  % (epoch, total_steps))
            model.save('latest')
            model.save(epoch)

        print('End of epoch %d / %d \t Time Taken: %d sec'
              % (epoch, opt.niter + opt.niter_decay,
                 time.time() - epoch_start_time))

        if epoch > opt.niter:
            model.update_learning_rate()
    return {'steps': total_steps // opt.batchSize,
            'step_seconds': step_seconds}


if __name__ == '__main__':
    main()
