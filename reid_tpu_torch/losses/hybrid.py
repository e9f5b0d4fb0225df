"""The training objective (ref `reid/losses/hybrid_losses.py`).

Counterpart of `reid_tpu/losses/hybrid.py`: triplet (+WRT when margin is
0) + lamda * center + cluster_factor * DCC, and the label-smoothed CE of
the continual phase (HybridLossWeighted). The centers take gradients; the
DCC tables are updated outside the loss (`update_dcc_luts`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import LossConfig
from .center import center_loss
from .dcc import DCCState, dcc_loss, init_dcc
from .identification import cross_entropy_label_smooth
from .triplet import (triplet_beta, triplet_loss_batch_hard,
                      weighted_regularized_triplet)


class HybridLossState(NamedTuple):
    centers: torch.Tensor   # (num_classes, feat_dim), trained
    dcc: DCCState           # (num_classes, num_classes) tables


def init_hybrid_state(num_classes: int, feat_dim: int,
                      generator: torch.Generator, device="cuda"
                      ) -> HybridLossState:
    """Centers from a standard normal (drawn on the host from `generator`),
    DCC tables of zeros. The tables are (C, C): DCC runs on the logits,
    whose class means seed them (ref center_contrastive_losses.py:113-124,
    image_reid_train.py:70-74)."""
    centers = torch.randn((num_classes, feat_dim), generator=generator)
    return HybridLossState(centers=centers.to(device),
                           dcc=init_dcc(num_classes, num_classes, device))


def hybrid_loss(state: HybridLossState, embeddings: torch.Tensor,
                logits: torch.Tensor, labels: torch.Tensor, cfg: LossConfig,
                embeddings_augment: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """(total, components). margin > 0 selects the batch-hard triplet (its
    beta form with weights or an augmented view), margin 0 the
    weighted-regularised triplet; then lamda * center, cluster_factor *
    DCC on the logits, and with `use_ce` the smoothed CE, unweighted as in
    the reference (hybrid_losses.py:85)."""
    if cfg.margin > 0:
        if weights is not None or embeddings_augment is not None:
            tri = triplet_beta(embeddings, labels, embeddings_augment,
                               weights, margin=cfg.margin)
        else:
            tri = triplet_loss_batch_hard(embeddings, labels,
                                          margin=cfg.margin)
    else:
        tri = weighted_regularized_triplet(embeddings, labels, weights)
    cen = center_loss(embeddings, labels, state.centers, weights)
    total = tri + cfg.center_lamda * cen
    aux = {"triplet": tri, "center": cen}
    if cfg.use_dcc and cfg.cluster_factor != 0.0:
        dcc = dcc_loss(logits, labels, state.dcc, scalar=cfg.dcc_scalar,
                       weight=cfg.dcc_weight)
        total = total + cfg.cluster_factor * dcc
        aux["dcc"] = dcc
    if cfg.use_ce:
        ce = cross_entropy_label_smooth(logits, labels, cfg.smoothing,
                                        cfg.epsilon, cfg.tao, None)
        total = total + ce
        aux["ce"] = ce
    return total, aux
