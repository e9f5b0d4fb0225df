"""Vectorized CMC / mAP evaluation (Market1501 protocol).

Counterpart of `reid_tpu/eval/cmc_map.py` (ref `reid/evaluate.py:33-105`):
one (Q, G) score matrix, a per-row argsort, junk-mask compaction through
cumulative sums, and the reference's trapezoid AP (ap += d_recall *
(old_precision + precision) / 2, with old_precision := 1 when the good hit
is at rank 0).

  good  = same pid, different cam       (ref :66-69)
  junk  = same pid + same cam, or pid == -1 (distractor)  (ref :70-72)
  queries with no good gallery match are skipped (ref :43-44), and CMC and
  mAP are divided by the total query count (ref :49-50)

The argsort is stable on both devices, as `jnp.argsort` is: re-ranked
distances tie in large groups, and the order among ties sets the AP. A
negative zero is made positive first, because the card's radix sort orders
-0.0 before +0.0 where `jnp.argsort` calls them equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _evaluate_scores(scores: torch.Tensor, ql, qc, gl, gc,
                     max_rank: int = 50
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = scores.device

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.int64)

    ql, qc, gl, gc = t(ql), t(qc), t(gl), t(gc)
    order = torch.argsort(-scores + 0.0, dim=1, stable=True)     # (Q, G)
    gl_sorted = gl[order]
    gc_sorted = gc[order]
    del order

    same_id = gl_sorted == ql[:, None]
    junk = (same_id & (gc_sorted == qc[:, None])) | (gl_sorted == -1)
    good = same_id & (gc_sorted != qc[:, None]) & ~junk
    del same_id, gl_sorted, gc_sorted

    # compact away junk columns: pos = rank among non-junk entries
    pos = torch.cumsum((~junk).to(torch.float32), dim=1) - 1.0
    ngood = good.sum(1)
    valid_q = ngood > 0

    goodf = good.to(torch.float32)
    i_idx = torch.cumsum(goodf, dim=1)                          # hits so far
    precision = i_idx / (pos + 1.0)
    old_precision = torch.where(
        pos > 0, (i_idx - 1.0) / torch.clamp(pos, min=1.0),
        torch.ones_like(pos))
    ap_terms = torch.where(good, (old_precision + precision) * 0.5,
                           torch.zeros_like(pos))
    ap = ap_terms.sum(1) / torch.clamp(ngood, min=1)
    ap = torch.where(valid_q, ap, torch.zeros_like(ap))

    # CMC: 1 from the first good compacted rank onward
    first_good = torch.where(good, pos, torch.full_like(pos, float("inf")))
    first_good = first_good.min(1).values
    ranks = torch.arange(max_rank, device=dev)[None, :]
    cmc_per_q = (ranks >= first_good[:, None]).to(torch.float32)
    cmc_per_q = torch.where(valid_q[:, None], cmc_per_q,
                            torch.zeros_like(cmc_per_q))
    # divided by the total query count as the compiled JAX program divides
    # by a constant: a multiplication by its f32 reciprocal
    inv_q = torch.tensor(np.float32(1.0) / np.float32(scores.shape[0]),
                         device=dev)
    return cmc_per_q.sum(0) * inv_q, ap.sum() * inv_q, valid_q


def _report(cmc: torch.Tensor, mean_ap: torch.Tensor, verbose: bool):
    cmc = cmc.cpu().numpy()
    mean_ap = float(mean_ap)
    if verbose:
        print("Rank@1:%f Rank@5:%f Rank@10:%f mAP:%f"
              % (cmc[0], cmc[4], cmc[9], mean_ap))
    return cmc, mean_ap


def evaluate_all(qf: torch.Tensor, ql, qc, gf: torch.Tensor, gl, gc,
                 max_rank: int = 50, verbose: bool = True):
    """CMC + mAP from features. Score = gf . qf (ref :58); full f32 only
    while TF32 is off."""
    scores = qf.to(torch.float32) @ gf.to(torch.float32).T
    cmc, mean_ap, _ = _evaluate_scores(scores, ql, qc, gl, gc, max_rank)
    return _report(cmc, mean_ap, verbose)


def evaluate_rerank(dist: torch.Tensor, ql, qc, gl, gc, max_rank: int = 50,
                    verbose: bool = True):
    """The same protocol from a (Q, G) distance matrix (Jaccard
    re-ranked)."""
    cmc, mean_ap, _ = _evaluate_scores(-torch.as_tensor(dist).to(
        torch.float32), ql, qc, gl, gc, max_rank)
    return _report(cmc, mean_ap, verbose)
