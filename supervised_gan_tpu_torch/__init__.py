"""supervised_gan_tpu_torch: the PyTorch / CUDA port of supervised_gan_tpu,
for one NVIDIA H100.

It sits beside the JAX package, mirrors its layout, and imports neither JAX
nor anything of the JAX package.  Activations are NCHW and weights keep
torch's layouts, so the reference's ``.pth`` checkpoints load directly.
Every TPU kernel on a ported path is a hand-written Hopper kernel
(``csrc/*.cu``, built at first use into ``build/``), each beside its plain
PyTorch version, which CPU tensors take.

Ported so far, for ``--model twostage_cycle`` (DSGAN): the sampler
(``python -m supervised_gan_tpu_torch.test``) and training
(``python -m supervised_gan_tpu_torch.train``).

Layout:
  options/      CLI surface (copy of the JAX package's)
  data/         datasets, augmentation, prefetch loader (copied)
  ops/          conv / norm / resample dispatch
  ops/kernels/  kernel wrappers + plain versions, autograd Functions, build
  csrc/         CUDA C++ sources
  nn/           layers, generators, discriminators, losses as torch modules
  models/       the twostage_cycle recipe, image pools, Adam, checkpoints
  utils/        images, HTML report, visualizer, .pth files, JAX-parameter
                import
"""

__version__ = "0.1.0"
