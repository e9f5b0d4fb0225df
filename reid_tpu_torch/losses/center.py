"""Center loss (ref `reid/losses/center_losses.py:7-71`).

Counterpart of `reid_tpu/losses/center.py`. The centers are a plain
(num_classes, feat_dim) tensor of the train state, updated by their own
SGD after a 1/lambda rescale (`train/state.py`).
"""

from __future__ import annotations

from typing import Optional

import torch


def center_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared distance of each embedding to its class center: the full
    (B, C) |x|^2 + |c|^2 - 2xc' matrix masked to the own class, clamped to
    [1e-12, 1e12], summed over B and divided by B (or weighted)."""
    x, c = embeddings.to(torch.float32), centers.to(torch.float32)
    distmat = (torch.sum(x * x, dim=1, keepdim=True)
               + torch.sum(c * c, dim=1)[None, :] - 2.0 * (x @ c.T))
    mask = labels[:, None] == torch.arange(c.shape[0],
                                           device=labels.device)[None, :]
    dist = torch.clamp(distmat * mask, 1e-12, 1e12)
    if weights is not None:
        return torch.sum(torch.sum(dist, dim=1) * weights)
    return torch.sum(dist) / x.shape[0]
