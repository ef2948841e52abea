"""Segmentation training with validation after every epoch: the
counterpart of the JAX package's train_ss.py (reference train_ss.py).

    python -m supervised_gan_tpu_torch.train_ss --dataroot <dir> \\
        --name <name> --model segmentation <architecture flags> \\
        --which_metric RandScore meanIU --best_metric meanIU \\
        [--gpu_ids -1 for the CPU]

The options are parsed twice, for the train and the val loader; after each
epoch the whole <dataroot>/val set runs in val mode at --valSize (default
--loadSize), unaugmented, one image at a time, and the model with the best
--best_metric so far is saved as ``best``.  Three Visualizers: the losses,
the train accuracies (display 10) and the val accuracies (display 20).  It
runs on ``cuda:<first --gpu_ids>``; with no CUDA device it raises unless
--gpu_ids -1 asks for the CPU.  TF32 is off (models/base.py
`disable_tf32`).

--data_mesh N (> 1) trains data-parallel and --spatial_mesh S (> 1) splits
the height, alone or as a grid, as the train entry point does
(parallel/mesh.py, parallel/spatial.py): N x S workers, each on its share
of every batch, rank 0 alone writing checkpoints and logs.  Validation runs
unsharded on every rank (``parallel.unsharded``), each on the whole val
set, so every rank keeps its generators in step and picks the same
``best``.  The printed losses are summed over each sp row and averaged
over the data rows; the train accuracies are read from maps gathered over
the sp row (models/segmentation.py) and averaged over the grid; the
displayed visuals and the checkpointed pools are whole.
"""

import ntpath
import os
import random
import re
import time

import numpy as np
import torch

from . import parallel
from .parallel import spatial
from .data import CreateDataLoader
from .models import create_model
from .models.base import disable_tf32
from .options import TrainOptions
from .utils.images import mkdirs, save_image
from .utils.visualizer import Visualizer


def main(args=None):
    """Train; returns {'steps', 'step_seconds', 'val_accs', 'best'}: the
    iterations run, the wall time of each up to a device synchronization
    (the first includes the kernels' build), each epoch's val accuracies
    and the best --best_metric value (None without one); under --data_mesh
    the first local worker's."""
    opt_train = TrainOptions().parse(args)
    opt_val = TrainOptions().parse(args)

    if opt_train.manualSeed is None:
        opt_train.manualSeed = random.randint(1, 10000)
    parallel.check_flags(opt_train)
    if parallel.sharded(opt_train):
        return parallel.launch(run, opt_train, (opt_val,))
    return run(opt_train, opt_val)


def run(opt_train, opt_val):
    """Training and validation on this process's device (a data-parallel
    worker's, in its process group)."""
    disable_tf32()
    main_rank = parallel.is_main()
    print('Random Seed: ', opt_train.manualSeed)
    random.seed(opt_train.manualSeed)
    np.random.seed(opt_train.manualSeed)

    data_loader = CreateDataLoader(opt_train)
    dataset = data_loader.load_data()
    dataset_size = len(data_loader)
    print('#training images = %d' % dataset_size)

    opt_val.phase = 'val'
    opt_val.nThreads = 1
    opt_val.batchSize = 1
    opt_val.serial_batches = True
    opt_val.no_flip = True
    opt_val.no_rotate = True
    opt_val.isTrain = False          # no augmentation in the val loader
    if opt_val.valSize == 0:
        opt_val.valSize = opt_val.loadSize
    opt_val.loadSize = opt_val.valSize
    opt_val.fineSize = opt_val.valSize
    data_loader_val = CreateDataLoader(opt_val)
    dataset_val = data_loader_val.load_data()
    print('#validation images = %d' % len(data_loader_val))

    model = create_model(opt_train)
    cuda = model.device.type == 'cuda'
    visualizer = Visualizer(opt_train) if main_rank else None
    opt_train.display_id = 10
    opt_train.display_title = 'train accuracy'
    visualizer_acc = Visualizer(opt_train) if main_rank else None
    opt_val.display_id = 20
    opt_val.display_title = 'val accuracy'
    opt_val.isTrain = True           # the Visualizer writes the train dirs
    visualizer_acc_val = Visualizer(opt_val) if main_rank else None

    total_steps = 0
    best_metric = -1
    step_seconds, val_accs = [], []
    chkpt_dir = os.path.join(opt_train.checkpoints_dir, opt_train.name)

    for epoch in range(1, opt_train.niter + opt_train.niter_decay + 1):
        epoch_start_time = time.time()
        model.reset_accs()
        for i, data in enumerate(dataset):
            iter_start_time = time.time()
            total_steps += opt_train.batchSize
            epoch_iter = total_steps - dataset_size * (epoch - 1)
            model.set_input(data)
            model.optimize_parameters()
            model.accum_accs()           # waits for the step's outputs
            if cuda:
                torch.cuda.synchronize(model.device)
            step_seconds.append(time.time() - iter_start_time)

            if total_steps % opt_train.display_freq == 0 and (
                    main_rank or spatial.active()):
                # under --spatial_mesh every rank gathers the visuals' rows
                visuals = model.get_current_visuals()
                if main_rank:
                    visualizer.display_current_results(visuals, epoch)

            if total_steps % opt_train.print_freq == 0:
                errors = parallel.mean_values(model.get_current_errors())
                accs = parallel.mean_values(model.get_current_accs(),
                                            shares=False)
                t = (time.time() - iter_start_time) / opt_train.batchSize
                if main_rank:
                    visualizer.print_current_errors(epoch, epoch_iter, errors,
                                                    t)
                    if opt_train.display_id > 0:
                        visualizer.plot_current_errors(
                            epoch, float(epoch_iter) / dataset_size, errors)
                    if accs:
                        visualizer_acc.plot_current_errors(
                            epoch, float(epoch_iter) / dataset_size, accs)

            if total_steps % opt_train.save_latest_freq == 0:
                print('saving the latest model (epoch %d, total_steps %d)'
                      % (epoch, total_steps))
                save(model, 'latest')

        # ------------------------------------- validation, every epoch -- #
        model.reset_accs()
        if opt_val.save_val_visuals and main_rank:
            img_dir = os.path.join(chkpt_dir, 'val', 'epoch%03d' % epoch)
            mkdirs(img_dir)
        for data in dataset_val:
            with parallel.unsharded():
                model.set_input(data)
                model.forward(val_mode=True)
            model.accum_accs()
            if opt_val.save_val_visuals and main_rank:
                visuals = model.get_current_visuals()
                name = os.path.splitext(
                    ntpath.basename(model.get_image_paths()[0]))[0]
                for label, image_numpy in visuals.items():
                    if re.search('image', label):
                        continue
                    save_image(image_numpy, os.path.join(
                        img_dir, '%s_%s.png' % (name, label)))

        accs = model.get_current_accs()
        val_accs.append({k: float(v) for k, v in accs.items()})
        if main_rank:
            print('validation (epoch %d): %s' % (epoch, ', '.join(
                '%s %.6f' % kv for kv in val_accs[-1].items())))
        if opt_val.best_metric != 'None' and accs:
            if accs[opt_val.best_metric] > best_metric:
                best_metric = accs[opt_val.best_metric]
                save(model, 'best')
        if accs and main_rank:
            visualizer_acc_val.plot_current_errors(epoch, 0.0, accs)

        if epoch % opt_train.save_epoch_freq == 0:
            print('saving the model at the end of epoch %d, iters %d'
                  % (epoch, total_steps))
            save(model, 'latest')
            save(model, epoch)

        print('End of epoch %d / %d \t Time Taken: %d sec'
              % (epoch, opt_train.niter + opt_train.niter_decay,
                 time.time() - epoch_start_time))

        if epoch > opt_train.niter:
            model.update_learning_rate()
    return {'steps': total_steps // opt_train.batchSize,
            'step_seconds': step_seconds, 'val_accs': val_accs,
            'best': (float(best_metric)
                     if opt_val.best_metric != 'None' else None)}


def save(model, label):
    """model.save(label) on rank 0, the pools whole; every rank waits until
    it is written."""
    with spatial.whole_pools(getattr(model, 'pools', {})):
        if parallel.is_main():
            model.save(label)
    parallel.barrier()


if __name__ == '__main__':
    main()
