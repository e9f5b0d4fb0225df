"""Ranked list loss (CVPR'19). Ref `reid/losses/ranked_losses.py:5-57`.

Counterpart of `reid_tpu/losses/ranked.py`: the reference's loop over
anchors with ragged gathers as one masked pass over the distance matrix.
"""

from __future__ import annotations

import torch

from .utils import euclidean_dist, normalize


def ranked_loss(global_feat: torch.Tensor, labels: torch.Tensor,
                margin: float = 1.3, alpha: float = 2.0, tval: float = 1.0,
                normalize_feature: bool = True) -> torch.Tensor:
    """mean over anchors of loss_ap + loss_an: loss_ap the mean over
    positives of relu(d_ap + margin - alpha) (the count of positives +
    1e-5 below), loss_an the mean of (alpha - d_an) over the negatives
    closer than alpha, weighted by exp(tval (alpha - d_an)) (ref
    :25-36)."""
    if normalize_feature:
        global_feat = normalize(global_feat)
    dist = euclidean_dist(global_feat, global_feat)
    is_pos = (labels[:, None] == labels[None, :]).to(torch.float32)
    is_neg = 1.0 - is_pos
    ap_val = torch.clamp(dist + (margin - alpha), min=0.0) * is_pos
    loss_ap = torch.sum(ap_val, dim=1) / (torch.sum(is_pos, dim=1) + 1e-5)
    close = is_neg * (dist < alpha).to(torch.float32)
    w = torch.exp(tval * (alpha - dist)) * close
    w_sum = torch.sum(w, dim=1) + 1e-5
    loss_an = torch.sum((alpha - dist) * w, dim=1) / w_sum
    return torch.mean(loss_ap + loss_an)
