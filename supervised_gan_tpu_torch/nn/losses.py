"""Loss functions (NCHW).

Counterparts of supervised_gan_tpu/nn/losses.py:18-75:
  * gan_loss            GANLoss: LSGAN -> MSE against a 0/1 target,
                        vanilla -> BCE on already-sigmoided predictions;
  * gan_loss_multiclass GANLossMultiClass: per-pixel CE over the channel
                        dim of N-class logits;
  * weighted_l1_loss    WeightedL1Loss;
  * cross_entropy_2d    CrossEntropyLoss2d of the segmentation head, with
                        optional per-class weights (losses.py:78-90 there);
  * seg_bce_loss        the sigmoid segmentation head's BCE, plain or with
                        the per-pixel class weight map, by plain autograd
                        (models/segmentation.py:211-229 there);
  * bce_loss            torch.nn.BCELoss numerics (log clamped at -100) with
                        the JAX package's custom gradient
                        (p - t) / max(p (1 - p), 1e-12): the plain autograd
                        of the clamped logs is NaN or inf at saturated
                        p = 0 or 1, which poisoned 512 px training (the
                        round-4 NaN fix, losses.py:32-42 there).
Every loss is computed in float32 whatever the prediction's dtype.

Under --spatial_mesh (parallel/spatial.py ``mean``) the map losses are this
rank's share: its rows of the map (of a replicated map, the rows the
partition gives it) summed over the map's global count; the sp ranks'
shares add up to the loss.
"""

import torch

from .. import parallel
from ..parallel import spatial


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
    return spatial.mean(_BCEElem.apply(pred.float(), target.float()))


def gan_loss(pred, target_is_real, use_lsgan=True):
    p = pred.float()
    target = 1.0 if target_is_real else 0.0
    if use_lsgan:
        return spatial.mean((p - target) ** 2)
    return bce_loss(p, torch.full_like(p, target))


def gan_loss_multiclass(logits, target_label):
    """logits (N, num_classes, H, W); target_label an int class id."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -spatial.mean(logp[:, target_label])


def weighted_l1_loss(x, y, w=None):
    z = (x.float() - y.float()).abs()
    if w is not None:
        z = z * w.float()
    return spatial.mean(z)


def cross_entropy_2d(logits, labels, weights=None):
    """logits (N, C, H, W), labels (N, H, W) class ids: the mean of
    -log softmax at the label; with per-class ``weights`` the weighted sum
    over the summed weights of the targets (torch NLLLoss2d)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    picked = logp.gather(1, labels.long().unsqueeze(1))[:, 0]
    if weights is None:
        return -picked.mean()
    # weights[label] with no host-to-device copy (a captured step holds
    # it); a label past the list takes its last weight, as a JAX gather
    w = torch.full_like(picked, float(weights[-1]))
    for i in reversed(range(len(weights) - 1)):
        w = torch.where(labels == i, float(weights[i]), w)
    # in a process group, over the ranks' mean weight sum: the mean of the
    # ranks' losses (and gradients) is then the global batch's ratio
    return -(picked * w).sum() / parallel.mean_all_reduce(w.sum())


def seg_bce_loss(p, target, weights=None):
    """Mean BCE of sigmoid probabilities ``p`` against the one-hot
    ``target`` (N, C, H, W), each log clamped at -100.  With per-class
    ``weights`` each pixel is weighted by 1 + sum_i target_i (w_i - 1) and
    log p is taken of p floored at 1e-12."""
    p, t = p.float(), target.float()
    if weights is None:
        terms = -(t * torch.log(p.clamp_min(0.0)).clamp_min(-100.0)
                  + (1 - t) * torch.log((1 - p).clamp_min(0.0))
                  .clamp_min(-100.0))
        return terms.mean()
    w = torch.ones_like(t[:, :1])
    for i, wi in enumerate(weights):
        w = w + t[:, i:i + 1] * (wi - 1.0)
    terms = -(t * torch.log(p.clamp(1e-12, 1.0)).clamp_min(-100.0)
              + (1 - t) * torch.log(1 - p).clamp_min(-100.0))
    return (terms * w).mean()
