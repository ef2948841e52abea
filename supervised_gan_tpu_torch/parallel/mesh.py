"""Data and spatial parallelism on torch.distributed: the counterpart of
supervised_gan_tpu/parallel/mesh.py.

The JAX package shards one jit program over a (data, sp) device mesh
(--data_mesh N, --spatial_mesh S; ``make_mesh`` there) and lets GSPMD insert
the collectives.  The port runs one process per device instead, PyTorch's
own idiom, behind the same command line.  The grid has N x S ranks (N 1
for --data_mesh 0 or 1), ordered as JAX's ``devs.reshape(nd, n_sp)``: rank
``d * S + s`` is data row d, sp index s.  Each data row of S ranks forms an
sp group (parallel/spatial.py: the image height split over it), each
column of N ranks a data group:

  * ``launch`` starts N x S workers (spawned), local worker i on
    ``cuda:i`` (or the CPU under --gpu_ids -1); with --dcn_num_processes P
    each of the P processes starts N S / P of them, global rank
    ``dcn_process_id * N S / P + i``, and all meet at
    ``tcp://<--dcn_coordinator>``.  NCCL on CUDA, gloo on the CPU.
  * A sharded step computes what the one-process step computes at the
    global --batchSize, only the reduction order differs: every rank loads
    the same global batch and keeps its rows (``rows``); every random draw
    is made at the global shape from generators all ranks share by seed,
    then cut to the rank's rows; BatchNorm sums its statistics across
    ranks (spatial.py ``sum_over``, differentiable); the image pools stay
    replicated and see the gathered batch (``gather_rows``); each
    optimizer averages its gradients before it steps
    (``average_gradients``); parameters start as rank 0's
    (``broadcast_modules``).  ``rows``, ``gather_rows``, ``world`` and
    ``rank`` work over the data group.  Under --spatial_mesh each rank's
    loss and gradients are its share of its data row's (parallel/
    spatial.py), so the gradients and the printed losses are summed over
    the sp group and averaged over the data group.

The hand-written kernels need no gate here: each rank runs them on its own
rows through the same wrappers (the JAX package turned its IN streaming off
under a mesh only because a pallas_call does not partition).

Without a process group every helper is the identity and nothing is
registered: --data_mesh 0 or 1 runs exactly the one-process path.
``unsharded()`` opens a region (the segmentation validation) where a rank
runs its own unsharded forward while its group stays up.

Where gloo carries a collective of a CUDA tensor (two ranks on one card),
the tensor goes through host memory: decided by the backend, once per call.
"""

import contextlib
import copy
import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# seconds a collective (and the rendezvous) may wait for the other ranks
TIMEOUT_S = 900

# {'rank', 'world', 'backend', 'device', 'n_data', 'n_sp', 'data', 'sp',
#  'data_group', 'sp_group', 'sp_ranks'} while joined: the global rank and
# size, the grid's shape, this rank's data row and sp index, and the
# torch.distributed groups of its data column and its sp row (None: the
# whole world) with the global ranks of the sp row
_group = None
_unsharded = 0       # depth of unsharded() regions


# ------------------------------------------------------ flags and launch -- #
def grid(opt):
    """(data rows, sp ranks a row) of the options: --data_mesh and
    --spatial_mesh, each 0 or 1 meaning one."""
    return (max(opt.data_mesh, 1), max(getattr(opt, 'spatial_mesh', 0), 1))


def workers(opt):
    """Ranks of the whole grid."""
    n, s = grid(opt)
    return n * s


def check_flags(opt):
    """Raise for a parallel flag set the training entry points cannot run:
    --batchSize not divisible by --data_mesh, or a --dcn_* set whose
    process count does not divide the grid's workers."""
    n, p = opt.data_mesh, opt.dcn_num_processes
    if n > 1 and opt.batchSize % n:
        raise ValueError('--batchSize %d is not divisible by --data_mesh %d: '
                         'each worker takes an equal share of the batch'
                         % (opt.batchSize, n))
    if p > 1:
        w = workers(opt)
        if w < p or w % p:
            if grid(opt)[1] == 1:
                raise ValueError('--data_mesh %d must be a multiple of '
                                 '--dcn_num_processes %d, at least one worker '
                                 'a process' % (n, p))
            raise ValueError('--data_mesh x --spatial_mesh, %d workers, must '
                             'be a multiple of --dcn_num_processes %d, at '
                             'least one worker a process' % (w, p))
        if not opt.dcn_coordinator:
            raise ValueError('--dcn_num_processes %d needs '
                             '--dcn_coordinator host:port' % p)
        if not 0 <= opt.dcn_process_id < p:
            raise ValueError('--dcn_process_id %d is not in [0, %d)'
                             % (opt.dcn_process_id, p))


def sharded(opt):
    """Whether the options ask for a parallel run (--data_mesh or
    --spatial_mesh > 1)."""
    return workers(opt) > 1


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def local_workers(opt):
    """The workers this process starts: the grid's / --dcn_num_processes."""
    return workers(opt) // max(opt.dcn_num_processes, 1)


def check_cards(opt):
    """Workers on CUDA need a card each: raise, naming both counts, when
    the machine has fewer (never share a card, never fall back to the CPU)."""
    if not opt.gpu_ids:
        return
    n, cards = local_workers(opt), torch.cuda.device_count()
    if cards < n:
        flags = ('--data_mesh %d' % opt.data_mesh if grid(opt)[1] == 1 else
                 '--data_mesh %d --spatial_mesh %d'
                 % (opt.data_mesh, opt.spatial_mesh))
        raise RuntimeError(
            '%s starts %d workers on this machine, one a CUDA card, but it '
            'has %d cards: fewer cards than workers (pass --gpu_ids -1 to run '
            'them on the CPU)' % (flags, n, cards))


def launch(fn, opt, args=(), join_timeout=None, timeout_s=TIMEOUT_S):
    """Run ``fn(opt, *args)`` in parallel: spawn this process's workers
    (``local_workers``), each in a process group of the grid's ranks, and
    return the first local worker's result.  An exception in any worker
    raises here, as does a join that outlasts ``join_timeout`` seconds
    (then every worker is killed)."""
    check_flags(opt)
    check_cards(opt)
    p = max(opt.dcn_num_processes, 1)
    n = local_workers(opt)
    coordinator = (opt.dcn_coordinator if p > 1
                   else '127.0.0.1:%d' % free_port())
    mp = torch.multiprocessing.get_context('spawn')
    results = mp.SimpleQueue()
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(fn, opt, args, coordinator, opt.dcn_process_id * n
                       if p > 1 else 0, results, timeout_s),
        nprocs=n, join=False, start_method='spawn')
    out = None
    try:
        deadline = (None if join_timeout is None
                    else datetime.datetime.now()
                    + datetime.timedelta(seconds=join_timeout))
        done = False
        while not done:
            done = ctx.join(timeout=1.0)
            # read while waiting: a large result fills the pipe
            while not results.empty():
                out = results.get()
            if (not done and deadline is not None
                    and datetime.datetime.now() > deadline):
                raise TimeoutError('the data-parallel workers did not end '
                                   'within %s s' % join_timeout)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return out


def _worker(i, fn, opt, args, coordinator, base, results, timeout_s):
    opt = copy.copy(opt)
    if opt.gpu_ids:
        device = torch.device('cuda', i)
        opt.gpu_ids = [i]
    else:
        device = torch.device('cpu')
        if not os.environ.get('OMP_NUM_THREADS'):
            # the workers share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // local_workers(opt)))
    init_distributed(coordinator, workers(opt), base + i, device=device,
                     timeout_s=timeout_s, n_sp=grid(opt)[1])
    try:
        # every rank takes rank 0's seed: the loaders' streams and the
        # generators must agree
        opt.manualSeed = int(broadcast_values([opt.manualSeed or 0])[0])
        out = fn(opt, *args)
        if i == 0:
            results.put(out)
    finally:
        shutdown()


# ------------------------------------------------------ the process group -- #
def init_distributed(coordinator, num_processes, process_id, backend=None,
                     device=None, timeout_s=TIMEOUT_S, n_sp=1):
    """Join the process group of ``num_processes`` ranks that meets at
    ``tcp://<coordinator>`` (host:port) as rank ``process_id``, working on
    ``device`` (the CPU by default), in a grid of ``num_processes / n_sp``
    data rows of ``n_sp`` sp ranks.  ``backend``: NCCL for a CUDA device,
    gloo for the CPU, unless given (two gloo ranks can share one card,
    which NCCL refuses)."""
    global _group
    world, rank, n_sp = int(num_processes), int(process_id), int(n_sp)
    if n_sp < 1 or world % n_sp:
        raise ValueError('%d ranks do not form rows of %d sp ranks'
                         % (world, n_sp))
    device = torch.device('cpu' if device is None else device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method='tcp://%s' % coordinator,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    n_data = world // n_sp
    data_group = sp_group = None
    sp_ranks = [rank]
    if n_sp > 1:
        # every rank makes every group, in one order
        for d in range(n_data):
            ranks = list(range(d * n_sp, (d + 1) * n_sp))
            g = dist.new_group(ranks)
            if rank in ranks:
                sp_group, sp_ranks = g, ranks
        for s in range(n_sp):
            ranks = list(range(s, world, n_sp))
            g = dist.new_group(ranks)
            if rank in ranks:
                data_group = g
    _group = {'rank': rank, 'world': world, 'backend': backend,
              'device': device, 'n_data': n_data, 'n_sp': n_sp,
              'data': rank // n_sp, 'sp': rank % n_sp,
              'data_group': data_group, 'sp_group': sp_group,
              'sp_ranks': sp_ranks}
    if n_sp > 1:
        from . import spatial
        spatial.enter()


def shutdown():
    """Leave the process group (a no-op outside one)."""
    global _group
    from . import spatial
    spatial.leave()
    if dist.is_initialized():
        dist.destroy_process_group()
    _group = None


def active():
    """Whether batch sharding is on: in a process group, outside
    ``unsharded()``."""
    return _group is not None and not _unsharded


def world():
    """Ranks of the data group (the batch split): 1 outside a group."""
    return _group['n_data'] if active() else 1


def rank():
    """This rank's index in its data group."""
    return _group['data'] if active() else 0


def is_main():
    """Whether this process writes the run's files: rank 0, or no group."""
    return _group is None or _group['rank'] == 0


@contextlib.contextmanager
def unsharded():
    """A region where this rank runs unsharded: ``rows``, the global draws
    and the BatchNorm all-reduce are the identity inside it."""
    global _unsharded
    _unsharded += 1
    try:
        yield
    finally:
        _unsharded -= 1


def barrier():
    if _group is not None:
        if _group['backend'] == 'nccl':
            dist.barrier(device_ids=[_group['device'].index])
        else:
            dist.barrier()


# -------------------------------------------------------------- batches -- #
def global_shape(shape):
    """A rank's batch shape -> the global batch's."""
    shape = tuple(shape)
    return (shape[0] * world(),) + shape[1:]


def rows(t):
    """This rank's rows of a global-batch tensor (leading axis)."""
    if not active():
        return t
    n, w = t.shape[0], world()
    if n % w:
        raise ValueError('a batch of %d rows does not split over %d ranks'
                         % (n, w))
    k = n // w
    return t[rank() * k:(rank() + 1) * k]


def _staged(t):
    """Whether a collective of ``t`` goes through host memory."""
    return _group['backend'] == 'gloo' and t.is_cuda


def all_reduce_sum_in_(t, group):
    """Sum ``t`` in place over ``group`` (None: every rank)."""
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_reduce_sum_(t):
    """Sum ``t`` in place over every rank of the grid."""
    return all_reduce_sum_in_(t, None)


def _data_reduce_sum_(t):
    """Sum ``t`` in place over the data group."""
    if _group['n_sp'] == 1:
        return _all_reduce_sum_(t)
    return all_reduce_sum_in_(t, _group['data_group'])


def gather_rows(t):
    """Every rank's rows of ``t`` in rank order: the global batch."""
    if not active():
        return t
    part = t.cpu() if _staged(t) else t.contiguous()
    parts = [torch.empty_like(part) for _ in range(world())]
    dist.all_gather(parts, part, group=_group['data_group'])
    return torch.cat(parts).to(t.device)


class _MeanAllReduce(torch.autograd.Function):
    """The mean over the data group; its backward is the mean of the
    cotangents, so each rank's gradient takes every rank's use of the
    mean."""

    @staticmethod
    def forward(ctx, t):
        return _data_reduce_sum_(
            t.clone(memory_format=torch.contiguous_format)).div_(world())

    @staticmethod
    def backward(ctx, g):
        return _data_reduce_sum_(
            g.clone(memory_format=torch.contiguous_format)).div_(world())


def mean_all_reduce(t):
    """The mean of ``t`` over the data group, differentiable (the identity
    outside a group)."""
    if not active():
        return t
    return _MeanAllReduce.apply(t)


def _comm_device():
    return _group['device'] if _group['backend'] == 'nccl' else 'cpu'


def mean_values(values, shares=True):
    """A dict of floats summed over the sp group and averaged over the data
    group (the identity outside a group): the printed losses, each rank's
    its share of its data row's.  With ``shares`` False each rank's values
    are its whole data row's (the segmentation accuracies, read from
    gathered maps): averaged over the whole grid."""
    if not active() or not values:
        return values
    t = torch.tensor([float(v) for v in values.values()], dtype=torch.float64,
                     device=_comm_device())
    dist.all_reduce(t)
    t /= world() if shares else _group['world']
    return type(values)(zip(values.keys(), t.tolist()))


def broadcast_values(values):
    """Rank 0's list of numbers on every rank."""
    if _group is None:
        return list(values)
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_comm_device())
    dist.broadcast(t, 0)
    return t.tolist()


# ---------------------------------------------------- parameters, grads -- #
def _flat_groups(tensors):
    """Tensors grouped by (device, dtype), in first-seen order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def broadcast_modules(modules):
    """Copy rank 0's parameters and buffers of ``modules`` into every rank,
    one flat buffer a (device, dtype), as DDP does at construction."""
    if not active():
        return
    tensors = [t for m in modules for t in m.state_dict().values()]
    with torch.no_grad():
        for group in _flat_groups(tensors):
            flat = _flatten_dense_tensors(group)
            if _staged(flat):
                host = flat.cpu()
                dist.broadcast(host, 0)
                flat.copy_(host)
            else:
                dist.broadcast(flat, 0)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)


def average_gradients(optimizer):
    """Register a step pre-hook on ``optimizer`` that replaces each
    parameter group's gradients by their sum over the grid divided by the
    data group's size (one flat all-reduce a group): the mean over ranks
    without --spatial_mesh, the sp shares summed and the data rows averaged
    with it; so every rank takes the global batch's step."""
    if not active():
        return

    def hook(opt, args, kwargs):
        if not active():
            return
        with torch.no_grad():
            for group in opt.param_groups:
                grads = [p.grad for p in group['params']
                         if p.grad is not None]
                for part in _flat_groups(grads):
                    flat = _all_reduce_sum_(
                        _flatten_dense_tensors(part)).div_(world())
                    for g, v in zip(part,
                                    _unflatten_dense_tensors(flat, part)):
                        g.copy_(v)

    optimizer.register_step_pre_hook(hook)
