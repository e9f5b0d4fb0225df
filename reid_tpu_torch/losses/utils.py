"""Distance and weighting primitives of the metric losses.

Counterpart of `reid_tpu/losses/utils.py` (ref `reid/losses/utils.py`):
plain tensor functions in f32. At batch scale these are small matmuls,
which `torch.matmul` serves; the gallery-scale distances are the kernels
of `ops/distance.py`.
"""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    """L2 normalize: x / max(|x|, eps)."""
    norm = torch.linalg.norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance sqrt(clamp(|x|^2 + |y|^2 - 2xy, 1e-12)),
    clamped before the root as the reference does (ref utils.py:21-35)."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    xx = torch.sum(xf * xf, dim=1, keepdim=True)
    yy = torch.sum(yf * yf, dim=1, keepdim=True)
    sq = xx + yy.T - 2.0 * (xf @ yf.T)
    return torch.sqrt(torch.clamp(sq, min=1e-12))


def cosine_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity (ref utils.py:12-18)."""
    return 1.0 - normalize(x.to(torch.float32)) @ normalize(
        y.to(torch.float32)).T


def softmax_weights(dist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over dim 1 restricted to `mask`, with 1e-6 added to the
    denominator (ref utils.py:4-9)."""
    max_v = torch.amax(dist * mask, dim=1, keepdim=True)
    diff = dist - max_v
    z = torch.sum(torch.exp(diff) * mask, dim=1, keepdim=True) + 1e-6
    return torch.exp(diff) * mask / z
