"""The one traffic generator: a mix file of parameters, the configuration's
image size and a seed give the host batches the window cycles through.

A mix (traffic/<name>.json) says:
  batch              images a step (--batchSize)
  steps_per_dispatch steps a dispatch: 1 runs set_input and
                     optimize_parameters a step, k > 1 one train_chunk of
                     k batches (train.py's dispatch)
  images             distinct images, drawn once; the window cycles through
                     them as through one cached epoch
  mean_low, mean_high  each image's channel draws its mean m from
                     U(mean_low, mean_high)
  amp_low, amp_high  and its half-width a from U(amp_low, amp_high); its
                     pixels are U(m - a, m + a): every image differs from the
                     next in its statistics too, so a step fed another
                     image than its own reads another loss
  warmup_dispatches  dispatches after the three checked steps, before the
                     window
  trace_dispatches   dispatches in the traced stretch of a --trace 1 run

The images are drawn on ``device`` from the seed in two calls and handed
over as the loader hands them: {'A': (batch, H, W, 3) float32 numpy,
'A_paths': [...]} (the single-image dataset mode).
"""

import json

import torch

KEYS = ('batch', 'steps_per_dispatch', 'images', 'mean_low', 'mean_high',
        'amp_low', 'amp_high', 'warmup_dispatches', 'trace_dispatches')


def load(path):
    with open(path) as f:
        mix = json.load(f)
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError('%s: missing %s' % (path, ', '.join(missing)))
    if mix['images'] % mix['batch']:
        raise ValueError('%s: %d images are not batches of %d'
                         % (path, mix['images'], mix['batch']))
    return mix


def draw(mix, shape, channel_axis, gen):
    """Images of ``shape`` (images first) with the mix's statistics: each
    image's channel (on ``channel_axis``) its own mean and half-width, from
    ``gen``, on its device."""
    stat = [1] * len(shape)
    stat[0], stat[channel_axis] = shape[0], shape[channel_axis]
    stats = torch.rand([2] + stat, generator=gen, device=gen.device)
    mean = stats[0] * (mix['mean_high'] - mix['mean_low']) + mix['mean_low']
    amp = stats[1] * (mix['amp_high'] - mix['amp_low']) + mix['amp_low']
    x = torch.rand(shape, generator=gen, device=gen.device)
    return mean + (2 * x - 1) * amp


def images(mix, size, seed, device):
    """(images, size, size, 3) float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return draw(mix, (mix['images'], size, size, 3), 3, gen)


def batches(mix, size, seed, device):
    """The host batches of one epoch of the mix, in order."""
    x = images(mix, size, seed, device).cpu().numpy()
    b = mix['batch']
    return [{'A': x[i:i + b],
             'A_paths': ['img%04d.png' % j for j in range(i, i + b)]}
            for i in range(0, len(x), b)]
