"""Replay buffers of generated images (the reference's ImagePool,
util/image_pool.py:5-42), with the semantics of supervised_gan_tpu/models/
pools.py:22-78: a (size, C, H, W) float32 tensor on the device plus a fill
count.

  * while not full: store the image, return it unchanged;
  * when full: with probability 1 - reject swap a random slot and return
    the evicted image, else pass the image through.

Each image draws its two decisions (a uniform and a slot) whether or not
the pool is full, from a CPU ``torch.Generator``; a caller may feed the
decisions in instead (``draws``).  Stored images are detached copies.
"""

import torch


def init_pool(pool_size, image_shape, device, dtype=torch.float32):
    """image_shape: (C, H, W).  Size 0 (or less) means no pool."""
    if pool_size <= 0:
        return None
    return {'images': torch.zeros((pool_size,) + tuple(image_shape),
                                  dtype=dtype, device=device),
            'num': 0}


def draw_decisions(pool, n, generator):
    """n (uniform, slot) pairs from ``generator``."""
    size = pool['images'].shape[0]
    return [(float(torch.rand((), generator=generator)),
             int(torch.randint(size, (), generator=generator)))
            for _ in range(n)]


def pool_query(pool, batch, generator=None, reject=0.5, draws=None):
    """batch (B, C, H, W) -> the pooled batch; updates ``pool`` in place."""
    if pool is None:
        return batch
    images = pool['images']
    size = images.shape[0]
    if draws is None:
        draws = draw_decisions(pool, batch.shape[0], generator)
    outs = []
    for x, (u, slot) in zip(batch.detach().to(images.dtype), draws):
        if pool['num'] < size:
            images[pool['num']] = x
            pool['num'] += 1
            outs.append(x)
        elif u > reject:
            outs.append(images[slot].clone())
            images[slot] = x
        else:
            outs.append(x)
    return torch.stack(outs)


def pool_sample(pool, batch_size, generator):
    """batch_size random stored images (the pool is assumed filled)."""
    size = pool['images'].shape[0]
    slots = torch.randint(size, (batch_size,), generator=generator)
    return pool['images'][slots.to(pool['images'].device)]


def pool_fill(pool, batch):
    """Pre-fill a pool with the first images of batch."""
    n = min(batch.shape[0], pool['images'].shape[0])
    pool['images'][:n] = batch[:n]
    pool['num'] = n
    return pool
