"""Inference post-processing: camera de-bias and tracklet smoothing.

Counterpart of `reid_tpu/ops/camera.py` (ref `reid/inference_utils.py`):
  - `diminish_camera_bias` (:5-15): per camera, mean-subtract, multiply by
    the ridge-regularized inverse Gram matrix P = (E^T E + n*lambda*I)^-1,
    then L2-renormalize;
  - `smooth_tracklets` (:18-27): per tracklet group, 0.1*self +
    0.9*group-mean, not renormalized.

The JAX package masks every row per camera; here each camera's rows are
selected, which adds the same nonzero terms without the zero rows. The
tracklet sums are 0/1 matmuls, which add in a fixed order on every run
(`segment_sum`'s role; a scatter-add on the card adds in whatever order its
atomics land).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_SEG_BLOCK = 2048        # tracklets summed per 0/1 matmul of smooth_tracklets


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def diminish_camera_bias(embeddings: torch.Tensor, cams: torch.Tensor,
                         lambda_reg: float = 0.05,
                         num_cams: Optional[int] = None) -> torch.Tensor:
    """Per-camera whitening (ref inference_utils.py:5-15). For each camera
    c with n_c rows E_c, the Gram matrix uses the UNCENTERED rows (the
    reference snapshots them before centering in place):
    P = (E_c^T E_c + n_c*lambda*I)^-1;  E_c <- (E_c - mean(E_c)) P;
    then every row is L2-normalized. Full f32 only while TF32 is off."""
    x = embeddings.to(torch.float32)
    cams = torch.as_tensor(cams, device=x.device)
    if num_cams is None:
        num_cams = int(cams.max()) + 1
    d = x.shape[1]
    eye = torch.eye(d, dtype=torch.float32, device=x.device)
    out = x.clone()
    for c in range(num_cams):
        sel = cams == c
        rows = x[sel]
        if rows.shape[0] == 0:
            continue
        n_c = np.float32(rows.shape[0])
        mean = rows.sum(0, keepdim=True) / float(n_c)
        gram = rows.T @ rows
        p = torch.linalg.inv(gram + float(n_c * np.float32(lambda_reg)) * eye)
        out[sel] = (rows - mean) @ p
    return _l2n(out)


def smooth_tracklets(embeddings: torch.Tensor, tracklet_ids: torch.Tensor,
                     alpha: float = 0.1) -> torch.Tensor:
    """Blend each embedding with its tracklet mean: a*self + (1-a)*mean
    (ref inference_utils.py:18-27, no renormalization). Rows with
    `tracklet_ids` < 0 pass through unchanged. The sums run over
    `_SEG_BLOCK` tracklets at a time, each block a (tracklets, N) 0/1 matrix
    times the embeddings. Full f32 only while TF32 is off."""
    x = embeddings.to(torch.float32)
    ids = torch.as_tensor(tracklet_ids, device=x.device).to(torch.int64)
    valid = ids >= 0
    if not bool(valid.any()):
        return x
    xv = x[valid]
    segs, seg = torch.unique(ids[valid], return_inverse=True)
    means = torch.empty((len(segs), x.shape[1]), device=x.device)
    for s in range(0, len(segs), _SEG_BLOCK):
        rows = torch.arange(s, min(s + _SEG_BLOCK, len(segs)), device=x.device)
        onehot = (seg[None, :] == rows[:, None]).to(torch.float32)
        means[s:s + _SEG_BLOCK] = (onehot @ xv) / onehot.sum(1, keepdim=True)
    out = x.clone()
    out[valid] = alpha * xv + (1.0 - alpha) * means[seg]
    return out
