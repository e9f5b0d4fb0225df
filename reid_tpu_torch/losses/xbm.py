"""Cross-batch memory (XBM; ref `reid/tricks/XBM.py`,
`losses/triplet_losses_xbm.py`).

Counterpart of `reid_tpu/losses/xbm.py`: a ring of detached embeddings and
their labels, label -1 for an empty slot, and the weighted-regularised
triplet of a batch against it. The ring pointer is a host integer, so an
enqueue reads nothing back from the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .triplet import softplus
from .utils import euclidean_dist, softmax_weights


class XBMState(NamedTuple):
    feats: torch.Tensor    # (K, D) f32
    labels: torch.Tensor   # (K,) int32; -1 = empty
    ptr: int               # ring pointer


def init_xbm(memory_size: int, feat_dim: int, device="cuda") -> XBMState:
    return XBMState(
        feats=torch.zeros((memory_size, feat_dim), dtype=torch.float32,
                          device=device),
        labels=torch.full((memory_size,), -1, dtype=torch.int32,
                          device=device),
        ptr=0)


def xbm_enqueue(state: XBMState, feats: torch.Tensor,
                labels: torch.Tensor) -> XBMState:
    """Write a batch at the ring pointer, wrapping (ref XBM.py:21-30); the
    batch size divides K."""
    b, k = feats.shape[0], state.feats.shape[0]
    idx = (state.ptr + torch.arange(b, device=feats.device)) % k
    return XBMState(
        feats=state.feats.index_copy(0, idx,
                                     feats.detach().to(torch.float32)),
        labels=state.labels.index_copy(0, idx, labels.to(torch.int32)),
        ptr=(state.ptr + b) % k)


def xbm_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                     state: XBMState,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weighted-regularised triplet of the batch against the memory
    (ref triplet_losses_xbm.py:14-46): a (B, K) distance matrix, empty
    slots masked out, and positives at distance <= 1e-4 dropped as the
    anchor's own enqueued copy."""
    dist = euclidean_dist(embeddings, state.feats)
    valid = (state.labels >= 0)[None, :]
    same = labels[:, None] == state.labels[None, :]
    is_pos = (same & valid & (dist > 1e-4)).to(torch.float32)
    is_neg = (~same & valid).to(torch.float32)
    dist_ap, dist_an = dist * is_pos, dist * is_neg
    w_ap = softmax_weights(dist_ap, is_pos)
    w_an = softmax_weights(-dist_an, is_neg)
    furthest_pos = torch.sum(dist_ap * w_ap, dim=1)
    closest_neg = torch.sum(dist_an * w_an, dim=1)
    per_anchor = softplus(-(closest_neg - furthest_pos))
    if weights is not None:
        return torch.sum(per_anchor * weights)
    return torch.mean(per_anchor)
