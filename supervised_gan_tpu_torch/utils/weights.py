"""Carry the JAX package's parameter trees into the port's modules.

The JAX side stores conv kernels HWIO and ConvTranspose kernels pre-flipped
HWIO (supervised_gan_tpu/utils/pth.py:62-89); the port keeps torch's
layouts.  Each key's kind is read from the port module that owns it, so
there is no hand-written table:

    Conv2d weight           HWIO -> OIHW
    ConvTranspose2d weight  pre-flipped HWIO -> un-flip, then (I, O, kh, kw)
    BatchNorm / biases      unchanged
"""

import numpy as np
import torch

from ..nn.core import Conv2d, ConvTranspose2d


def _flatten(tree, prefix=''):
    flat = {}
    for k, v in tree.items():
        path = k if not prefix else prefix + '.' + k
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def from_jax_params(module, params):
    """params: nested dicts of arrays (as ``jax.device_get`` returns them)
    -> a state_dict for ``module`` that loads with strict=True (buffers such
    as BatchNorm running statistics are taken from the module)."""
    owners = dict(module.named_modules())
    sd = {}
    for path, arr in _flatten(params).items():
        owner, _, leaf = path.rpartition('.')
        m = owners.get(owner)
        if m is None:
            raise KeyError('no module %r in %s for parameter %s'
                           % (owner, type(module).__name__, path))
        a = np.asarray(arr, dtype=np.float32)
        if leaf == 'weight' and isinstance(m, ConvTranspose2d):
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == 'weight' and isinstance(m, Conv2d):
            a = a.transpose(3, 2, 0, 1)
        sd[path] = torch.from_numpy(np.ascontiguousarray(a))
    for name, buf in module.named_buffers():
        sd.setdefault(name, buf.detach().clone())
    return sd
