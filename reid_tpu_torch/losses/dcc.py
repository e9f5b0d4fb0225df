"""Dual cluster-contrastive (DCC) loss (ref
`reid/losses/center_contrastive_losses.py`).

Counterpart of `reid_tpu/losses/dcc.py`. The reference updates its two
lookup tables inside the loss's backward; here, as in the JAX package, the
tables are state that the loss reads without gradient and
`update_dcc_luts` replaces once per step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .utils import normalize


class DCCState(NamedTuple):
    lut_ccc: torch.Tensor   # (num_classes, feat_dim) cluster-center table
    lut_icc: torch.Tensor   # (num_classes, feat_dim) instance table


def init_dcc(num_classes: int, feat_dim: int, device="cuda") -> DCCState:
    """Zero tables (ref :82-83); `train.image_train.seed_dcc_luts` seeds
    them from class means before the first epoch."""
    z = torch.zeros((num_classes, feat_dim), dtype=torch.float32,
                    device=device)
    return DCCState(lut_ccc=z, lut_icc=z.clone())


def _smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def _ce_label_smooth(logits: torch.Tensor, labels: torch.Tensor,
                     smoothing: float = 0.1) -> torch.Tensor:
    n_cls = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), n_cls).to(torch.float32)
    target = onehot * (1.0 - smoothing) + smoothing / n_cls
    return -torch.mean(torch.sum(target * logp, dim=-1))


def dcc_loss(embeddings: torch.Tensor, labels: torch.Tensor,
             state: DCCState, scalar: float = 20.0, weight: float = 0.25
             ) -> torch.Tensor:
    """CE of the scaled similarities to lut_ccc, plus CE to lut_icc, plus
    `weight` times the smooth-L1 consistency of the two (ref :87-110).
    The gradient reaches only `embeddings`: the tables are detached, and so
    is the lut_icc side of the consistency term."""
    x = embeddings.to(torch.float32)
    out_ccc = scalar * (x @ state.lut_ccc.detach().T)
    out_icc = scalar * (x @ state.lut_icc.detach().T)
    loss_ccc = _ce_label_smooth(out_ccc, labels, 0.1)
    loss_icc = _ce_label_smooth(out_icc, labels, 0.1)
    loss_con = _smooth_l1(out_ccc, out_icc.detach())
    return loss_ccc + loss_icc + weight * loss_con


def class_ranks(labels: torch.Tensor) -> torch.Tensor:
    """Each sample's rank among the earlier samples of its class."""
    eq = labels[:, None] == labels[None, :]
    earlier = torch.ones_like(eq).tril_(-1)
    return (eq & earlier).sum(1)


@torch.no_grad()
def update_dcc_luts(state: DCCState, embeddings: torch.Tensor,
                    labels: torch.Tensor, momentum: float = 0.1,
                    rounds: Optional[int] = None) -> DCCState:
    """The momentum update of both tables (ref backward :47-62).

    lut_ccc[y] <- normalize(m lut_ccc[y] + (1 - m) normalize(mean_y)) for
    every class y of the batch. lut_icc[y] is the reference's sequential
    EMA over the batch's instances, normalized after each (the JAX
    package's `lax.scan` over B). Instances of different classes touch
    different rows, so round r updates, at once, every class's instance of
    rank r among its class's instances in batch order: `rounds` rounds,
    the largest count of one class in the batch (K under PK sampling).
    Without `rounds` it is read from the labels (one host read)."""
    x = embeddings.detach().to(torch.float32)
    n_cls, dim = state.lut_ccc.shape
    onehot = F.one_hot(labels.long(), n_cls).to(torch.float32)     # (B, C)
    counts = onehot.sum(0)
    means = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    new_ccc = normalize(momentum * state.lut_ccc
                        + (1.0 - momentum) * normalize(means))
    new_ccc = torch.where((counts > 0)[:, None], new_ccc, state.lut_ccc)

    ranks = class_ranks(labels)
    if rounds is None:
        rounds = int(ranks.max()) + 1
    # one spare row takes the writes of the instances outside the round
    lut = torch.cat([state.lut_icc, x.new_zeros((1, dim))])
    labels = labels.long()
    for r in range(rounds):
        row = lut.index_select(0, labels) * momentum + (1.0 - momentum) * x
        row = normalize(row)
        target = torch.where(ranks == r, labels, n_cls)
        lut.index_copy_(0, target, row)
    return DCCState(lut_ccc=new_ccc, lut_icc=lut[:n_cls])
