"""Circle loss (CVPR'20). Ref `reid/losses/circle_losses.py:9-66`.

Counterpart of `reid_tpu/losses/circle.py`: the reference's ragged
upper-triangular pair vectors as masks over the whole similarity matrix,
in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG = -1e9


def circle_loss(normed_feature: torch.Tensor, labels: torch.Tensor,
                m: float = 0.35, gamma: float = 64.0) -> torch.Tensor:
    """softplus(logsumexp(negative logits) + logsumexp(positive logits)) /
    B. Positives: the upper triangle with the diagonal of the same-label
    matrix; negatives: the strict upper triangle of the different-label
    one (ref convert_label_to_similarity, :17-28). The margins' weights
    ap and an take no gradient."""
    f = normed_feature.to(torch.float32)
    sim = f @ f.T
    n = sim.shape[0]
    same = labels[:, None] == labels[None, :]
    ones = torch.ones((n, n), dtype=torch.bool, device=sim.device)
    pos_mask = same & torch.triu(ones, 0)
    neg_mask = ~same & torch.triu(ones, 1)
    ap = torch.clamp(-sim.detach() + 1.0 + m, min=0.0)
    an = torch.clamp(sim.detach() + m, min=0.0)
    logit_p = -ap * (sim - (1.0 - m)) * gamma
    logit_n = an * (sim - m) * gamma
    neg = torch.full((), _NEG, device=sim.device)
    lse_p = torch.logsumexp(torch.where(pos_mask, logit_p, neg).ravel(), 0)
    lse_n = torch.logsumexp(torch.where(neg_mask, logit_n, neg).ravel(), 0)
    return F.softplus(lse_n + lse_p) / n
