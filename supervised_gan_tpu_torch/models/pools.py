"""Replay buffers of generated images (the reference's ImagePool,
util/image_pool.py:5-42), with the semantics of supervised_gan_tpu/models/
pools.py:22-78: a (size, C, H, W) float32 tensor on the device plus a fill
count.

  * while not full: store the image, return it unchanged;
  * when full: with probability 1 - reject swap a random slot and return
    the evicted image, else pass the image through.

Each image draws its two decisions (a uniform and a slot) whether or not
the pool is full, from a CPU ``torch.Generator``; a caller may feed the
draws in instead (``draws``).  The fill count lives on the host, so the
draws turn into one row per image on the host (``decide``: the slot to
read and write, whether to store the image, whether to return the evicted
one), and the device applies the rows without a branch (``pool_apply``, as
the JAX package's pool_query does): one indexed read, one indexed write (a
self-write when the image is passed through), one select.  A captured CUDA
graph of a train step holds that form, with the rows fed in as data.
Stored images are detached copies.

A sampled pool (the fixed-noise pool of --use_fixed_noise1) is only read:
its slots are drawn on the host too (``sample_rows``, rows of the same
form, each reading its slot and storing nothing) and gathered on the
device (``pool_take``).

Under --spatial_mesh a pool of a row-sharded height holds this rank's rows
of its images (``height``: the images' global height); every rank applies
the same rows, so the ranks' pools together are the unsharded pool.
"""

import torch

from ..parallel import spatial

REJECT = 0.5


def init_pool(pool_size, image_shape, device, dtype=torch.float32):
    """image_shape: (C, H, W), global.  Size 0 (or less) means no pool."""
    if pool_size <= 0:
        return None
    return {'images': torch.zeros(
        (pool_size,) + spatial.local_shape(image_shape), dtype=dtype,
        device=device), 'num': 0, 'height': tuple(image_shape)[-2]}


def draw_decisions(pool, n, generator):
    """n (uniform, slot) pairs from ``generator``."""
    size = pool['images'].shape[0]
    return [(float(torch.rand((), generator=generator)),
             int(torch.randint(size, (), generator=generator)))
            for _ in range(n)]


def decide(pool, draws, reject=REJECT):
    """The rows (slot, store, evicted) of one query, one per image, from its
    draws; advances ``pool['num']`` as the query will fill the pool."""
    size = pool['images'].shape[0]
    rows = []
    for u, slot in draws:
        if pool['num'] < size:
            rows.append((pool['num'], 1, 0))
            pool['num'] += 1
        elif u > reject:
            rows.append((slot, 1, 1))
        else:
            rows.append((slot, 0, 0))
    return rows


def pool_apply(pool, batch, rows):
    """batch (B, C, H, W) -> the pooled batch; ``rows`` (B, 3) int64 on the
    pool's device, from ``decide``.  Updates ``pool['images']`` in place, an
    image at a time, so two images of one batch on one slot see each
    other."""
    images = pool['images']
    outs = []
    for i, x in enumerate(batch.detach().to(images.dtype)):
        slot = rows[i, :1]
        old = images.index_select(0, slot)[0]
        images.index_copy_(0, slot, torch.where(rows[i, 1] > 0, x, old)[None])
        outs.append(torch.where(rows[i, 2] > 0, old, x))
    return torch.stack(outs)


def pool_query(pool, batch, generator=None, reject=REJECT, draws=None):
    """batch (B, C, H, W) -> the pooled batch; updates ``pool`` in place."""
    if pool is None:
        return batch
    if draws is None:
        draws = draw_decisions(pool, batch.shape[0], generator)
    rows = torch.tensor(decide(pool, draws, reject), dtype=torch.int64,
                        device=pool['images'].device)
    return pool_apply(pool, batch, rows)


def sample_rows(pool, n, generator):
    """The rows of n random stored images (the pool is assumed filled):
    (slot, store 0, evicted 1), one slot drawn from ``generator`` each."""
    size = pool['images'].shape[0]
    return [(int(torch.randint(size, (), generator=generator)), 0, 1)
            for _ in range(n)]


def pool_take(pool, rows):
    """The stored images at the slots of ``rows`` ((B, 3) int64 on the
    pool's device, from ``sample_rows``)."""
    return pool['images'].index_select(0, rows[:, 0])


def pool_sample(pool, batch_size, generator):
    """batch_size random stored images (the pool is assumed filled)."""
    rows = torch.tensor(sample_rows(pool, batch_size, generator),
                        dtype=torch.int64, device=pool['images'].device)
    return pool_take(pool, rows)


def pool_fill(pool, batch):
    """Pre-fill a pool with the first images of batch."""
    n = min(batch.shape[0], pool['images'].shape[0])
    pool['images'][:n] = batch[:n]
    pool['num'] = n
    return pool
