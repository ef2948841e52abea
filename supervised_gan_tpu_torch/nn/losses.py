"""Loss functions (NCHW).

Counterparts of supervised_gan_tpu/nn/losses.py:18-75:
  * gan_loss            GANLoss: LSGAN -> MSE against a 0/1 target,
                        vanilla -> BCE on already-sigmoided predictions;
  * gan_loss_multiclass GANLossMultiClass: per-pixel CE over the channel
                        dim of N-class logits;
  * weighted_l1_loss    WeightedL1Loss;
  * bce_loss            torch.nn.BCELoss numerics (log clamped at -100) with
                        the JAX package's custom gradient
                        (p - t) / max(p (1 - p), 1e-12): the plain autograd
                        of the clamped logs is NaN or inf at saturated
                        p = 0 or 1, which poisoned 512 px training (the
                        round-4 NaN fix, losses.py:32-42 there).
Every loss is computed in float32 whatever the prediction's dtype.
"""

import torch


def _safe_log(x):
    return torch.log(x.clamp_min(0.0)).clamp_min(-100.0)


class _BCEElem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        return -(t * _safe_log(p) + (1.0 - t) * _safe_log(1.0 - p))

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        denom = (p * (1.0 - p)).clamp_min(1e-12)
        return (g * (p - t) / denom,
                g * (_safe_log(1.0 - p) - _safe_log(p)))


def bce_loss(pred, target):
    """Mean binary cross entropy; pred in [0, 1]."""
    return _BCEElem.apply(pred.float(), target.float()).mean()


def gan_loss(pred, target_is_real, use_lsgan=True):
    p = pred.float()
    target = 1.0 if target_is_real else 0.0
    if use_lsgan:
        return ((p - target) ** 2).mean()
    return bce_loss(p, torch.full_like(p, target))


def gan_loss_multiclass(logits, target_label):
    """logits (N, num_classes, H, W); target_label an int class id."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -logp[:, target_label].mean()


def weighted_l1_loss(x, y, w=None):
    z = (x.float() - y.float()).abs()
    if w is not None:
        z = z * w.float()
    return z.mean()
