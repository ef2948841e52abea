"""GAN training entry point: the counterpart of the JAX package's train.py
(reference train.py), with the same flags.

    python -m supervised_gan_tpu_torch.train --dataroot <dir> --name <name> \\
        --model twostage_cycle <architecture and loss flags> \\
        [--compute_dtype bfloat16] [--gpu_ids -1 for the CPU]

It owns the epoch / iteration loop, seeding, the display / print / save
cadence and the linear lr decay after --niter epochs; each iteration is one
model.optimize_parameters().  It runs on ``cuda:<first --gpu_ids>``; with no
CUDA device it raises unless --gpu_ids -1 asks for the CPU.  TF32 is off
(models/base.py `disable_tf32`).

--steps_per_dispatch k accumulates batches and runs them as one
``model.train_chunk`` (on a card: replays of the captured step,
models/graph.py), flushing early at every step whose display, print or
save must see that step's outputs, at the profiled steps 9, 19 and 20 (x
batchSize), at the epoch's last full batch and at the epoch's end, as the
JAX loop does (train.py:41-76 there).  Each chunk's size is printed.

Unlike the JAX loop, which never blocks, it synchronizes the device after
every dispatch (a step, or a chunk), so ``step_seconds`` times each to its
end (the bench, ``python -m supervised_gan_tpu_torch.bench``, times windows
of steps with no synchronize inside).  --profile_dir traces the steps from
total_steps == 10 x batchSize to 20 x batchSize (train.py:47-49, 72-76
there) with torch.profiler and writes ``<profile_dir>/*.pt.trace.json``; a
trace in which a kernel launch lost its device record fails the run and is
not written (utils/profile.py).

--data_mesh N (> 1) trains data-parallel (parallel/mesh.py): this process
spawns N workers (N / P with --dcn_num_processes P, the rest on the other
hosts), worker i on ``cuda:i`` (with --gpu_ids -1 on the CPU), each on its
share of every global batch of --batchSize; the run computes the
one-process run's steps.  Rank 0 alone writes the checkpoints, the full
state, loss_log.txt and the web page (the others wait at a barrier after
each save); the printed losses are the ranks' mean; only rank 0 profiles.
A machine with fewer cards than workers raises.

--spatial_mesh S (> 1) splits every image's height over S ranks
(parallel/spatial.py; every recipe), alone or in a grid with --data_mesh N
(N x S workers, the sp index the minor one): the printed losses are summed
over each row of S ranks and averaged over the N rows, the displayed
visuals and the checkpointed pools are gathered from the S ranks, and the
steps run one by one (no captured graph).
"""

import random
import time

import numpy as np
import torch

from . import parallel
from .parallel import spatial
from .data import CreateDataLoader
from .models import create_model
from .models.base import disable_tf32
from .options import TrainOptions
from .utils.profile import Trace
from .utils.visualizer import Visualizer


def main(args=None):
    """Train; returns {'steps', 'step_seconds', 'chunks', 'trace'}: the
    iterations run, the wall time of each dispatch (optimize_parameters(),
    or train_chunk() under --steps_per_dispatch) up to a device
    synchronization (the first includes the kernels' build), the steps of
    each dispatch, and for --profile_dir {'path', 'launches', 'kernels',
    'primer_lost'} of the trace written (else None); under --data_mesh the
    first local worker's."""
    opt = TrainOptions().parse(args)
    if opt.manualSeed is None:
        opt.manualSeed = random.randint(1, 10000)
    parallel.check_flags(opt)
    if parallel.sharded(opt):
        return parallel.launch(run, opt)
    return run(opt)


def run(opt):
    """The training loop on this process's device (a data-parallel
    worker's, in its process group)."""
    disable_tf32()
    main_rank = parallel.is_main()
    print('Random Seed: ', opt.manualSeed)
    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)

    data_loader = CreateDataLoader(opt)
    dataset = data_loader.load_data()
    dataset_size = len(data_loader)
    print('#training images = %d' % dataset_size)

    model = create_model(opt)
    visualizer = Visualizer(opt) if main_rank else None
    cuda = model.device.type == 'cuda'
    spd = max(1, opt.steps_per_dispatch)
    total_steps = 0
    step_seconds = []
    chunks = []
    trace = written = None

    def dispatch(batches, start):
        if spd > 1:
            model.train_chunk(batches)
            print('dispatched a chunk of %d steps (to step %d)'
                  % (len(batches), total_steps))
        else:
            model.set_input(batches[0])
            model.optimize_parameters()
        if cuda:
            torch.cuda.synchronize(model.device)
        step_seconds.append(time.time() - start)
        chunks.append(len(batches))

    for epoch in range(1, opt.niter + opt.niter_decay + 1):
        epoch_start_time = time.time()
        pending = []
        for i, data in enumerate(dataset):
            iter_start_time = time.time()
            total_steps += opt.batchSize
            epoch_iter = total_steps - dataset_size * (epoch - 1)
            if (opt.profile_dir and main_rank
                    and total_steps == 10 * opt.batchSize):
                trace = Trace(model.device).start()
            if not pending:
                dispatch_start = iter_start_time
            pending.append(data)
            boundary = (total_steps % opt.display_freq == 0
                        or total_steps % opt.print_freq == 0
                        or total_steps % opt.save_latest_freq == 0
                        or (opt.profile_dir
                            and total_steps in (9 * opt.batchSize,
                                                19 * opt.batchSize,
                                                20 * opt.batchSize))
                        or i + 1 == dataset_size // opt.batchSize)
            if len(pending) < spd and not boundary:
                continue
            dispatch(pending, dispatch_start)
            pending = []
            if trace is not None and total_steps == 20 * opt.batchSize:
                trace.stop(graph_kernels=model.graph_kernels())
                written = dict(path=trace.export(opt.profile_dir),
                               launches=trace.launches,
                               kernels=trace.kernels,
                               primer_lost=trace.primer_lost)
                trace = None
                print('profiler trace written to %s' % opt.profile_dir)

            if total_steps % opt.display_freq == 0 and (
                    main_rank or spatial.active()):
                # under --spatial_mesh every rank gathers the visuals' rows
                visuals = model.get_current_visuals()
                if main_rank:
                    visualizer.display_current_results(visuals, epoch)

            if total_steps % opt.print_freq == 0:
                errors = parallel.mean_values(model.get_current_errors())
                t = (time.time() - iter_start_time) / opt.batchSize
                if main_rank:
                    visualizer.print_current_errors(epoch, epoch_iter, errors,
                                                    t)
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
                save(model, 'latest')

        if pending:
            dispatch(pending, time.time())

        if epoch % opt.save_epoch_freq == 0:
            print('saving the model at the end of epoch %d, iters %d'
                  % (epoch, total_steps))
            save(model, 'latest')
            save(model, epoch)

        print('End of epoch %d / %d \t Time Taken: %d sec'
              % (epoch, opt.niter + opt.niter_decay,
                 time.time() - epoch_start_time))

        if epoch > opt.niter:
            model.update_learning_rate()
    if trace is not None:
        trace.prof.stop()
        print('profiler trace not written: the run ended at step %d, before '
              'step %d' % (total_steps, 20 * opt.batchSize))
    return {'steps': total_steps // opt.batchSize,
            'step_seconds': step_seconds, 'chunks': chunks, 'trace': written}


def save(model, label):
    """model.save(label) on rank 0, the pools whole; every rank waits until
    it is written."""
    with spatial.whole_pools(getattr(model, 'pools', {})):
        if parallel.is_main():
            model.save(label)
    parallel.barrier()


if __name__ == '__main__':
    main()
