"""Triplet losses (ref `reid/losses/triplet_losses.py`).

Counterpart of `reid_tpu/losses/triplet.py`: the positives and negatives
are chosen by masked reductions over the whole (B, B) distance matrix,
never by boolean gathers, so each loss is a fixed set of launches with no
host read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .utils import euclidean_dist, normalize, softmax_weights

_BIG = 1e9


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as `jax.nn.softplus` computes it (logaddexp), with
    no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _pos_neg_masks(labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    eq = labels[:, None] == labels[None, :]
    return eq.to(torch.float32), (~eq).to(torch.float32)


def _reduce(per_anchor: torch.Tensor, weights: Optional[torch.Tensor]):
    if weights is not None:
        return torch.sum(per_anchor * weights)
    return torch.mean(per_anchor)


def weighted_regularized_triplet(embeddings: torch.Tensor,
                                 labels: torch.Tensor,
                                 weights: Optional[torch.Tensor] = None,
                                 normalize_feature: bool = False
                                 ) -> torch.Tensor:
    """Soft-margin triplet over softmax-weighted positives and negatives
    (ref triplet_losses.py:15-45): softplus(furthest_pos - closest_neg),
    both softmax-weighted expectations."""
    feat = normalize(embeddings) if normalize_feature else embeddings
    dist = euclidean_dist(feat, feat)
    is_pos, is_neg = _pos_neg_masks(labels)
    dist_ap, dist_an = dist * is_pos, dist * is_neg
    w_ap = softmax_weights(dist_ap, is_pos)
    w_an = softmax_weights(-dist_an, is_neg)
    furthest_pos = torch.sum(dist_ap * w_ap, dim=1)
    closest_neg = torch.sum(dist_an * w_an, dim=1)
    return _reduce(softplus(-(closest_neg - furthest_pos)), weights)


def hard_example_mining(dist: torch.Tensor, labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-hard mining: each anchor's largest positive and smallest
    negative distance (ref triplet_losses.py:72-124)."""
    is_pos, is_neg = _pos_neg_masks(labels)
    dist_ap = torch.amax(dist - (1.0 - is_pos) * _BIG, dim=1)
    dist_an = torch.amin(dist + (1.0 - is_neg) * _BIG, dim=1)
    return dist_ap, dist_an


def triplet_loss_batch_hard(embeddings: torch.Tensor, labels: torch.Tensor,
                            margin: float = 0.3, alpha: float = 0.0,
                            smooth: bool = False,
                            weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Batch-hard margin-ranking triplet (ref triplet_losses.py:127-172):
    relu(margin - (d_an - (1 + alpha) d_ap)), or its softplus form with
    `smooth`."""
    dist = euclidean_dist(embeddings, embeddings)
    dist_ap, dist_an = hard_example_mining(dist, labels)
    gap = dist_an - (1.0 + alpha) * dist_ap
    per_anchor = softplus(margin - gap) if smooth \
        else torch.clamp(margin - gap, min=0.0)
    return _reduce(per_anchor, weights)


def triplet_beta(embeddings: torch.Tensor, labels: torch.Tensor,
                 embeddings_augment: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None,
                 margin: float = 0.3, beta: float = 0.0) -> torch.Tensor:
    """Beta-penalized triplet (ref triplet_losses.py:175-233, :48-69):
    relu((1 + b) d_ap - (1 - b) d_an + (1 - b) / (1 + b) margin), the
    positives mined from the augmented view when one is given."""
    dist = euclidean_dist(embeddings, embeddings)
    if embeddings_augment is not None:
        dist_aug = euclidean_dist(embeddings, embeddings_augment)
        is_pos, _ = _pos_neg_masks(labels)
        dist_ap = torch.amax(dist_aug - (1.0 - is_pos) * _BIG, dim=1)
        _, dist_an = hard_example_mining(dist, labels)
    else:
        dist_ap, dist_an = hard_example_mining(dist, labels)
    pen_margin = (1.0 - beta) * margin / (1.0 + beta)
    per_anchor = torch.clamp(
        -((1.0 - beta) * dist_an - (1.0 + beta) * dist_ap) + pen_margin,
        min=0.0)
    return _reduce(per_anchor, weights)


def semi_hard_triplet(embeddings: torch.Tensor, labels: torch.Tensor,
                      margin: float = 0.3) -> torch.Tensor:
    """TF-style semi-hard triplet (ref triplet_losses.py:236-349): for each
    anchor-positive pair the closest negative farther than the positive,
    else the farthest negative."""
    dist = euclidean_dist(embeddings, embeddings)
    n = dist.shape[0]
    is_pos, is_neg = _pos_neg_masks(labels)
    d_ij, d_ik = dist[:, :, None], dist[:, None, :]
    valid_neg = is_neg[:, None, :]
    outside = valid_neg * (d_ik > d_ij).to(torch.float32)
    neg_outside = torch.amin(d_ik + (1 - outside) * _BIG, dim=2)
    has_outside = torch.any(outside > 0, dim=2)
    neg_easiest = torch.amax(d_ik * valid_neg, dim=2)
    semi = torch.where(has_outside, neg_outside, neg_easiest)
    pair_mask = is_pos - torch.eye(n, device=dist.device)
    per_pair = torch.clamp(margin + dist - semi, min=0.0) * pair_mask
    num_pos = torch.clamp(torch.sum(pair_mask), min=1.0)
    return torch.sum(per_pair) / num_pos
