"""Identification losses (ref `reid/losses/identification_losses.py`).

Counterpart of `reid_tpu/losses/identification.py`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy_label_smooth(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.1, epsilon: float = 0.0,
                               tao: float = 1.0,
                               weights: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Label-smoothed CE on logits / `tao`, plus the poly term
    epsilon * (1 - pt) (ref identification_losses.py:39-75)."""
    n_cls = logits.shape[-1]
    logits = logits.to(torch.float32) / tao
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), n_cls).to(torch.float32)
    target = onehot * (1.0 - smoothing) + smoothing / n_cls
    per_sample = -torch.sum(target * logp, dim=-1)
    if epsilon > 0:
        pt = torch.sum(onehot * F.softmax(logits, dim=-1), dim=-1)
        per_sample = per_sample + epsilon * (1.0 - pt)
    if weights is not None:
        return torch.sum(per_sample * weights)
    return torch.mean(per_sample)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, epsilon: float = 0.0,
               class_weights: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Focal loss with the poly extension (ref identification_losses.py:
    6-36)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    pt = torch.sum(onehot * torch.exp(logp), dim=-1)
    ce = -torch.sum(onehot * logp, dim=-1)
    loss = ((1.0 - pt) ** gamma) * ce
    if epsilon > 0:
        loss = loss + epsilon * (1.0 - pt) ** (gamma + 1.0)
    if class_weights is not None:
        loss = loss * class_weights[labels.long()]
    return torch.mean(loss)


def label_smoothing_nll(logits: torch.Tensor, labels: torch.Tensor,
                        smoothing: float = 0.1, epsilon: float = 0.0
                        ) -> torch.Tensor:
    """(1 - smoothing) * NLL + smoothing * mean(-logp), plus the poly term
    (ref identification_losses.py:78-105)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    loss = (1.0 - smoothing) * nll + smoothing * -torch.mean(logp, dim=-1)
    if epsilon > 0:
        loss = loss + epsilon * (1.0 - torch.exp(-nll))
    return torch.mean(loss)
