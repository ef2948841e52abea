"""Seeded weights, made on the device in three draws and handed to both
sides: the reference's init (conv weights N(0, 0.02), BatchNorm weights
N(1, 0.02) and biases 0, conv biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
over every net of a reference recipe, in state_dict order."""

import torch

from .reference.nets import init_specs


def make(recipe, seed, device):
    """{net label: state_dict} for ``recipe``'s nets, float32 on
    ``device``; the recipe's own nets take the same values."""
    specs = [(label, name, t, kind, bound)
             for label, net in recipe.nets.items()
             for name, t, kind, bound in init_specs(net)]
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(t.numel() for _, _, t, k, _ in specs if k in ('w', 'bn'))
    n_unif = sum(t.numel() for _, _, t, k, _ in specs if k == 'b')
    normal = torch.randn(n_normal, generator=gen, device=device) * 0.02
    unif = torch.rand(n_unif, generator=gen, device=device) * 2 - 1
    out = {label: {} for label in recipe.nets}
    i = j = 0
    for label, name, t, kind, bound in specs:
        n = t.numel()
        if kind in ('w', 'bn'):
            v = normal[i:i + n] + (1.0 if kind == 'bn' else 0.0)
            i += n
        elif kind == 'b':
            v = unif[j:j + n] * bound
            j += n
        else:
            v = torch.full((n,), 1.0 if kind == 'one' else 0.0,
                           device=device)
        out[label][name] = v.view(t.shape)
    with torch.no_grad():
        for label, net in recipe.nets.items():
            net.load_state_dict(out[label], strict=True)
    return out
