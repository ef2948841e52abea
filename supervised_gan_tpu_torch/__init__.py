"""supervised_gan_tpu_torch: the PyTorch / CUDA port of supervised_gan_tpu,
for one NVIDIA H100.

It sits beside the JAX package, mirrors its layout, and imports neither JAX
nor anything of the JAX package.  Activations are NCHW and weights keep
torch's layouts, so the reference's ``.pth`` checkpoints load directly.
Every TPU kernel on a ported path is a hand-written Hopper kernel
(``csrc/*.cu``, built at first use into ``build/``), each beside its plain
PyTorch version, which CPU tensors take.

Ported so far: the DSGAN sampler (``python -m supervised_gan_tpu_torch.test``
with ``--model twostage_cycle``).

Layout:
  options/      CLI surface (copy of the JAX package's)
  ops/          conv / norm / resample dispatch
  ops/kernels/  kernel wrappers + plain versions, nvcc build
  csrc/         CUDA C++ sources
  nn/           layers and generators as torch modules
  models/       the twostage_cycle sampler
  utils/        images, HTML report, .pth files, JAX-parameter import
"""

__version__ = "0.1.0"
