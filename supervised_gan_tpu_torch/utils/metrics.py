"""Evaluation metrics: a copy of supervised_gan_tpu/utils/metrics.py.

  * compute_rand_f_scores — Rand F-score over connected components
    (reference util/util.py:86-128): threshold S,T at 0.5, label connected
    components with background=1, build the joint histogram and compute
    F = 2/(1/prec + 1/rec) with the background-row handling.
(The streaming confusion-matrix accumulation lives with its consumer in
models/segmentation.py:SegAccumulatorMixin, mirroring the reference
formulas exactly — reference models/segm_model.py:309-333.)
"""

import numpy as np


def _label_components(mask_bool):
    """8-connected component labeling of ``~mask_bool`` with background
    (mask == True) mapped to 0 — the semantics of
    skimage.measure.label(x, background=1) on a boolean image.  Uses
    scipy.ndimage (skimage is not a dependency); component numbering may
    differ from skimage's but the Rand F-score is invariant to label
    permutation."""
    from scipy import ndimage
    labels, _ = ndimage.label(~mask_bool, structure=np.ones((3, 3), bool))
    return labels


def compute_rand_f_scores(S, T, do_thin=False):
    S = np.asarray(S)
    T = np.asarray(T)
    if S.ndim == 2:
        S = S.reshape((1, 1) + S.shape)
        T = T.reshape((1, 1) + T.shape)
    num_images = T.shape[0]
    scores = np.zeros(num_images)
    for k in range(num_images):
        t = np.squeeze(T[k], axis=0) > 0.5
        s = np.squeeze(S[k], axis=0) > 0.5
        if do_thin:
            from skimage.morphology import thin
            s = thin(s)
        t_label = _label_components(t)
        s_label = _label_components(s)
        t_max = t_label.max()
        s_max = s_label.max()
        # joint histogram via bincount (vectorized; the reference loops pixels)
        joint = np.bincount(
            (t_label.ravel() * (s_max + 1) + s_label.ravel()),
            minlength=(t_max + 1) * (s_max + 1)
        ).reshape(t_max + 1, s_max + 1).astype(np.float64)
        p_ = joint[1:, :]
        n = joint.sum()
        p_ = p_ / n
        p__ = p_[:, 1:]
        pi0 = p_[:, 0]
        aux = pi0.sum()
        ai = p_.sum(axis=1)
        bj = p__.sum(axis=0)
        sum_a2 = np.power(ai, 2).sum()
        sum_b2 = np.power(bj, 2).sum() + aux / n
        sum_ab2 = np.power(p__, 2).sum() + aux / n
        prec = sum_ab2 / sum_b2
        rec = sum_ab2 / sum_a2
        scores[k] = 2.0 / (1.0 / prec + 1.0 / rec)
    return scores
