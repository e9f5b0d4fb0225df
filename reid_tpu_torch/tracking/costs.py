"""Association cost matrices: IoU, DIoU, appearance cosine.

Counterpart of `reid_tpu/tracking/costs.py`. Boxes are tlwh; a (..., T, 4)
and b (..., D, 4) give (..., T, D) matrices computed in one batched pass
(the leading axis is the stream axis of a batched tracker).
"""

from __future__ import annotations

import torch


def _corners(boxes):
    return boxes[..., :2], boxes[..., :2] + boxes[..., 2:4]


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain IoU. a (..., T, 4), b (..., D, 4) tlwh -> (..., T, D)."""
    a_tl, a_br = _corners(a)
    b_tl, b_br = _corners(b)
    tl = torch.maximum(a_tl[..., :, None, :], b_tl[..., None, :, :])
    br = torch.minimum(a_br[..., :, None, :], b_br[..., None, :, :])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] * a[..., 3])[..., :, None]
    area_b = (b[..., 2] * b[..., 3])[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def diou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DIoU = IoU - center_dist^2 / enclosing_diagonal^2."""
    a_tl, a_br = _corners(a)
    b_tl, b_br = _corners(b)
    a_c = 0.5 * (a_tl + a_br)
    b_c = 0.5 * (b_tl + b_br)
    d = torch.sum((a_c[..., :, None, :] - b_c[..., None, :, :]) ** 2, dim=-1)
    out_tl = torch.minimum(a_tl[..., :, None, :], b_tl[..., None, :, :])
    out_br = torch.maximum(a_br[..., :, None, :], b_br[..., None, :, :])
    rou = torch.sum((out_tl - out_br) ** 2, dim=-1)
    return iou_matrix(a, b) - d / torch.clamp(rou, min=1e-9)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12) along the last axis."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def appearance_cost(track_feats: torch.Tensor,
                    det_feats: torch.Tensor) -> torch.Tensor:
    """Cosine distance between L2-normalized track EMA features and
    detection embeddings: (..., T, D)."""
    return 1.0 - l2_normalize(track_feats) @ l2_normalize(
        det_feats).transpose(-1, -2)
