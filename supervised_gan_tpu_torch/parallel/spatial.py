"""The image height split over the sp group (--spatial_mesh S): the port's
counterpart of the JAX package's 'sp' mesh axis (parallel/mesh.py:38-59
there), where GSPMD places the batch with P('data', 'sp') and inserts every
halo exchange and cross-shard reduction.  Here each op does that itself.

Layout.  A tensor of NCHW activations (any tensor whose rows are its
second-to-last axis) is either row-sharded or replicated, decided from its
GLOBAL height H alone, so every rank takes the same branch: H of at least
MIN_ROWS rows a rank is sharded, rank r holding the global rows
``[r H // S, (r + 1) H // S)`` (``bounds``); a smaller H (the noise, G1's
first layers, the unet's innermost levels, the CRN's coarse blocks, the
smallest PatchGAN maps) stays whole on every sp rank.  A sharded tensor
carries its global height as the attribute ``_sp_h`` (``mark``); a
replicated one carries nothing.  While a group with S > 1 is up, a
TorchFunctionMode (``_Rows``) copies the mark from an op's inputs to each
output of the same local height, so elementwise ops, casts, concatenations
over channels and detaches keep it; every op that moves rows sets its
output's mark itself.

Moves between layouts, each differentiable:
  * ``replicate``: an all-gather; its backward sums the ranks' gradients
    over the sp group and keeps this rank's rows;
  * ``fetch_rows``: the global rows [lo, hi) a rank's op reads, zero rows
    past the image's edges; each rank sends the rows others need of its
    own (point to point), and its backward sends each halo's gradient back
    to the rank that owns the rows, which adds it to its own;
  * ``map_rows``: an op that reads a window of input rows for each of its
    output rows (a convolution, the resampling): the output's rows of this
    rank from the input rows they read (``fetch_rows``), or, where the
    output is replicated, the op on the whole input (``replicate``).

Gradients.  Every loss is cut to this rank's rows of its map, summed, and
divided by the map's global count (``mean``), so a rank's loss and its
gradients are its share: the gradient of a replicated tensor or of a
parameter is the sum of the sp ranks' (parallel/mesh.py average_gradients
sums them), and a sharded tensor's own rows hold their whole gradient once
the halo gradients have come back.  Plane statistics (InstanceNorm, ops/
norm.py) and BatchNorm's sums are all-reduced (``sp_sum_``, ``sum_over``).

Without a group of S > 1 (or inside parallel.unsharded()) every helper is
the identity and nothing is marked.  Collectives of a CUDA tensor on gloo
(ranks sharing one card) go through host memory.
"""

import collections
import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from . import mesh

# rows a rank below which a tensor stays replicated
MIN_ROWS = 8
_MODE = None
# collectives made since the last reset, by kind: 'fetch' and 'fetch_grad'
# (the halo exchanges), 'replicate' and 'replicate_grad', 'sp_sum' (the
# plane statistics), 'sum_over' and 'sum_over_grad' (BatchNorm's sums)
COUNTS = collections.Counter()


# ---------------------------------------------------------------- layout -- #
def active():
    """Whether the height is split: in a group of S > 1 sp ranks, outside
    parallel.unsharded()."""
    g = mesh._group
    return g is not None and g['n_sp'] > 1 and not mesh._unsharded


def size():
    return mesh._group['n_sp'] if active() else 1


def index():
    return mesh._group['sp'] if active() else 0


def is_split(h):
    """Whether a tensor of global height ``h`` is row-sharded."""
    return active() and h >= MIN_ROWS * size()


def bounds(h, r=None):
    """Global rows [lo, hi) of sp rank ``r`` (this rank by default)."""
    n = size()
    r = index() if r is None else r
    return r * h // n, (r + 1) * h // n


def sharded(t):
    return active() and getattr(t, '_sp_h', None) is not None


def height(t):
    """The global height of ``t``: its mark, or its own rows."""
    h = getattr(t, '_sp_h', None) if active() else None
    return t.shape[-2] if h is None else h


def mark(t, h):
    """Mark ``t`` as global height ``h`` if that height is sharded (then
    ``t`` must hold this rank's rows), else clear its mark; returns t."""
    if is_split(h):
        lo, hi = bounds(h)
        if t.shape[-2] != hi - lo:
            raise ValueError('a tensor of %d rows is not sp rank %d\'s rows '
                             '[%d, %d) of height %d'
                             % (t.shape[-2], index(), lo, hi, h))
        t._sp_h = h
        return t
    return _clear(t)


def _clear(t):
    """``t`` without a mark (a window or a whole tensor that a propagated
    mark would misdescribe)."""
    if getattr(t, '_sp_h', None) is not None:
        del t._sp_h
    return t


def local_shape(shape):
    """A global shape (rows at -2) -> this rank's."""
    shape = tuple(shape)
    h = shape[-2]
    if not is_split(h):
        return shape
    lo, hi = bounds(h)
    return shape[:-2] + (hi - lo,) + shape[-1:]


def cut(t, h=None):
    """This rank's rows of a whole tensor (global height ``h``, its own by
    default), marked; a replicated height returns ``t``."""
    h = t.shape[-2] if h is None else h
    if not is_split(h):
        return t
    lo, hi = bounds(h)
    return mark(t.narrow(-2, lo, hi - lo).contiguous(), h)


def draw_like(t, draw):
    """A random draw for ``t``: ``draw(shape)`` at t's global height, cut to
    its rows (every sp rank draws the same numbers)."""
    if not sharded(t):
        return draw(t.shape)
    h = t._sp_h
    return cut(draw(tuple(t.shape[:-2]) + (h,) + tuple(t.shape[-1:])), h)


# ------------------------------------------------- mark propagation mode -- #
def _first_mark(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            h = getattr(a, '_sp_h', None)
            if h is not None:
                return h, a.shape[-2]
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    h = getattr(b, '_sp_h', None)
                    if h is not None:
                        return h, b.shape[-2]
    return None


def _mark_outputs(out, h, rows):
    if isinstance(out, torch.Tensor):
        if (out.dim() >= 3 and out.shape[-2] == rows
                and getattr(out, '_sp_h', None) is None):
            out._sp_h = h
    elif isinstance(out, (list, tuple)):
        for o in out:
            _mark_outputs(o, h, rows)


class _Rows(TorchFunctionMode):
    """Copies a row-sharded input's mark to every output of its local
    height."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        m = _first_mark(args)
        if m is None and kwargs:
            m = _first_mark(kwargs.values())
        if m is not None:
            _mark_outputs(out, *m)
        return out


def enter():
    """Turn mark propagation on in this thread (a group of S > 1 joined)."""
    global _MODE
    if _MODE is None:
        _MODE = _Rows()
        _MODE.__enter__()


def leave():
    global _MODE
    if _MODE is not None:
        _MODE.__exit__(None, None, None)
        _MODE = None


def quiet():
    """A region without mark propagation (the ops' own internals)."""
    return torch._C.DisableTorchFunction()


# ------------------------------------------------------------ the wire -- #
def _wire(t):
    """``t`` as a collective takes it: contiguous, on the host for gloo."""
    return t.contiguous().cpu() if mesh._staged(t) else t.contiguous()


def sp_sum_(t):
    """Sum ``t`` in place over the sp group (the plane statistics)."""
    COUNTS['sp_sum'] += 1
    return mesh.all_reduce_sum_in_(t, mesh._group['sp_group'])


def _exchange(sends, recvs, device):
    """Point to point: ``sends`` [(sp rank, tensor)], ``recvs`` [(sp rank,
    shape, dtype)]; returns the received tensors on ``device``."""
    host = mesh._group['backend'] == 'gloo' and device.type == 'cuda'
    peers = mesh._group['sp_ranks']
    bufs = [torch.empty(shape, dtype=dtype, device='cpu' if host else device)
            for _, shape, dtype in recvs]
    ops = ([dist.P2POp(dist.irecv, b, peers[r])
            for b, (r, _, _) in zip(bufs, recvs)]
           + [dist.P2POp(dist.isend, _wire(t), peers[r]) for r, t in sends])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(device) for b in bufs]


def _overlap(a, b, c, d):
    lo, hi = max(a, c), min(b, d)
    return (lo, hi) if lo < hi else None


def _rows_of(t, lo, hi):
    return t.narrow(-2, lo, hi - lo)


def _trade(t, t_span, give, out, out_span, take, add):
    """Each sp rank r gets the rows of ``t`` (global rows ``t_span``) that
    lie in ``give[r]``; ``out`` (global rows ``out_span``) gets, from each
    rank r, its rows that lie in ``take[r]`` (this rank's from ``t``),
    copied in, or added in rank order with ``add``."""
    me = index()
    sends, recvs, places = [], [], []
    for r in range(size()):
        if r == me:
            continue
        o = _overlap(*give[r], *t_span)
        if o:
            sends.append((r, _rows_of(t, o[0] - t_span[0], o[1] - t_span[0])))
        o = _overlap(*out_span, *take[r])
        if o:
            recvs.append((r, tuple(t.shape[:-2]) + (o[1] - o[0],)
                          + tuple(t.shape[-1:]), t.dtype))
            places.append((r, o))
    pieces = list(zip(places, _exchange(sends, recvs, t.device)))
    o = _overlap(*out_span, *t_span)
    if o:
        pieces.append(((me, o), _rows_of(t, o[0] - t_span[0],
                                         o[1] - t_span[0])))
    for (_, (lo, hi)), piece in sorted(pieces, key=lambda p: p[0][0]):
        dst = _rows_of(out, lo - out_span[0], hi - out_span[0])
        if add:
            dst.add_(piece)
        else:
            dst.copy_(piece)
    return out


class _Fetch(torch.autograd.Function):
    """Global rows [a, b) = ranges[this rank] of a sharded x of height h,
    zero past its edges; its backward sends each window's gradient back to
    the rows' owners, which add it."""

    @staticmethod
    def forward(ctx, x, h, ranges):
        COUNTS['fetch'] += 1
        own = [bounds(h, r) for r in range(size())]
        a, b = ranges[index()]
        ctx.own, ctx.ranges, ctx.shape = own, ranges, tuple(x.shape)
        with quiet():
            out = x.new_zeros(tuple(x.shape[:-2]) + (b - a,)
                              + tuple(x.shape[-1:]))
            return _trade(x, own[index()], ranges, out, (a, b), own, False)

    @staticmethod
    def backward(ctx, g):
        COUNTS['fetch_grad'] += 1
        with quiet():
            dx = g.new_zeros(ctx.shape)
            return (_trade(g, ctx.ranges[index()], ctx.own, dx,
                           ctx.own[index()], ctx.ranges, True), None, None)


def fetch_rows(x, ranges):
    """The global rows [a, b) = ``ranges[index()]`` of x, zero rows past its
    edges, differentiably; ``ranges`` holds every sp rank's window (each
    rank must know what the others read of its rows)."""
    a, b = ranges[index()]
    if sharded(x):
        return _clear(_Fetch.apply(x, x._sp_h, [tuple(r) for r in ranges]))
    lo = max(a, 0)
    hi = max(min(b, x.shape[-2]), lo)
    with quiet():
        y = _rows_of(x, lo, hi)
        return F.pad(y, [0, 0, lo - a, b - hi]) if (lo - a or b - hi) else y


class _Replicate(torch.autograd.Function):
    """The whole tensor from the sp ranks' rows (an all-gather); backward:
    the ranks' gradients summed, this rank's rows kept."""

    @staticmethod
    def forward(ctx, x, h):
        COUNTS['replicate'] += 1
        with quiet():
            n = size()
            # all_gather takes equal shapes: each part padded to ceil(h / n)
            part = F.pad(_wire(x), [0, 0, 0, -(-h // n) - x.shape[-2]])
            parts = [torch.empty_like(part) for _ in range(n)]
            dist.all_gather(parts, part, group=mesh._group['sp_group'])
            out = torch.cat([_rows_of(p, 0, hi - lo) for p, (lo, hi) in
                             zip(parts, (bounds(h, r) for r in range(n)))],
                            -2).to(x.device)
        ctx.h = h
        return out

    @staticmethod
    def backward(ctx, g):
        COUNTS['replicate_grad'] += 1
        with quiet():
            g = mesh.all_reduce_sum_in_(
                g.clone(memory_format=torch.contiguous_format),
                mesh._group['sp_group'])
            lo, hi = bounds(ctx.h)
            dx = _rows_of(g, lo, hi).contiguous()
        return dx, None


def replicate(x):
    """The whole tensor on every sp rank (x itself if it is not sharded),
    differentiably."""
    if not sharded(x):
        return x
    return _clear(_Replicate.apply(x, x._sp_h))


def full(x):
    """The whole tensor, no gradient (visuals, checkpoints)."""
    with torch.no_grad():
        return replicate(x)


def _sum_in_(t, over_sp):
    """Sum ``t`` in place over the whole grid or over the data group."""
    return mesh._all_reduce_sum_(t) if over_sp else mesh._data_reduce_sum_(t)


class _SumOver(torch.autograd.Function):
    """The sum over the grid or the data group (``over_sp``); its backward
    sums the cotangents over it."""

    @staticmethod
    def forward(ctx, t, over_sp):
        COUNTS['sum_over'] += 1
        ctx.over_sp = over_sp
        with quiet():
            return _sum_in_(t.clone(memory_format=torch.contiguous_format),
                            over_sp)

    @staticmethod
    def backward(ctx, g):
        COUNTS['sum_over_grad'] += 1
        with quiet():
            return _sum_in_(g.clone(memory_format=torch.contiguous_format),
                            ctx.over_sp), None


def sum_over(t, over_sp):
    """The sum of ``t`` over the whole grid (``over_sp``: the statistics of a
    sharded tensor) or over the data group (a replicated one),
    differentiably; the identity outside a group (or in mesh.unsharded())."""
    if mesh._group is None or mesh._unsharded:
        return t
    return _SumOver.apply(t, over_sp)


# ----------------------------------------------------------------- ops -- #
def map_rows(x, h_out, need, run, whole):
    """An op whose output rows each read a window of input rows: this
    rank's output rows [lo, hi) of global height ``h_out`` are
    ``run(rows, a, lo, hi)``, where ``rows`` are the global input rows
    [a, b) = ``need(lo, hi)`` (fetched, zero past the edges); a replicated
    output is ``whole(x)`` on the replicated input."""
    if not is_split(h_out):
        y = whole(replicate(x))
        return mark(y, h_out)
    ranges = [need(*bounds(h_out, r)) for r in range(size())]
    lo, hi = bounds(h_out)
    rows = fetch_rows(x, ranges)
    y = run(rows, ranges[index()][0], lo, hi)
    return mark(y, h_out)


def mean(t):
    """The mean of a map's terms ``t`` (rows at -2) as this rank's share: its
    rows' sum over the map's global count (the sp ranks' shares add up to
    the mean)."""
    if not active():
        return t.mean()
    if t.dim() < 2:
        raise NotImplementedError('--spatial_mesh: a loss over a map without '
                                  'rows (shape %s) is not yet ported'
                                  % (tuple(t.shape),))
    h = height(t)
    part = t
    if not sharded(t):
        lo, hi = bounds(h)
        part = t.narrow(-2, lo, hi - lo)
    return part.sum() / (t.numel() // t.shape[-2] * h)


# ------------------------------------------------------------- the pools -- #
@contextlib.contextmanager
def whole_pools(pools):
    """A region where each sharded pool's images are whole (gathered over
    the sp group, every sp rank entering it): what a checkpoint stores."""
    saved = {}
    try:
        for name, p in pools.items():
            if p is not None and p.get('height') and is_split(p['height']):
                saved[name] = p['images']
                p['images'] = full(mark(p['images'], p['height']))
        yield
    finally:
        for name, images in saved.items():
            pools[name]['images'] = images


__all__ = ['MIN_ROWS', 'active', 'bounds', 'cut', 'draw_like', 'enter',
           'fetch_rows', 'full', 'height', 'index', 'is_split', 'leave',
           'local_shape', 'map_rows', 'mark', 'mean', 'quiet', 'replicate',
           'sharded', 'size', 'sp_sum_', 'sum_over', 'whole_pools']
