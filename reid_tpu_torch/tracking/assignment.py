"""Linear assignment on the device.

Counterpart of `reid_tpu/tracking/assignment.py`. The JAX package runs the
early-exit loops as `lax.while_loop`s on the device; eager PyTorch has no
device-side loop, so each round here reads its exit condition on the host
(one small synchronisation per round). The matchings are the JAX ones: ties
break to the first index, as `argmin` / `argmax` do in both frameworks.
"""

from __future__ import annotations

import torch

INF_COST = 10.0


def _top2(values: torch.Tensor):
    """Per-row best and second-best values and the best index; ties go to
    the lower index, as `lax.top_k` keeps them."""
    best = torch.argmax(values, dim=1)
    top1 = values.gather(1, best[:, None])[:, 0]
    rest = values.scatter(1, best[:, None], float("-inf"))
    top2 = torch.amax(rest, dim=1)
    return top1, top2, best


def auction_assign(cost: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Min-cost perfect matching on a square (N, N) matrix (Bertsekas
    parallel auction). Returns row_to_col (N,) int32."""
    n = cost.shape[0]
    dev = cost.device
    benefit = -cost.to(torch.float32)
    max_iters = int(4 * n * (2 * INF_COST / eps + n))
    prices = torch.zeros(n, device=dev)
    r2c = torch.full((n,), -1, dtype=torch.int64, device=dev)
    c2r = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(n, device=dev)
    it = 0
    while it < max_iters and bool((r2c < 0).any()):
        unassigned = r2c < 0
        values = benefit - prices[None, :]
        top1, top2, best_col = _top2(values)
        bid_amount = top1 - top2 + eps
        bids = torch.where(unassigned, prices[best_col] + bid_amount,
                           float("-inf"))
        # for each column, the highest bidder among unassigned rows wins
        col_bids = torch.where(best_col[:, None] == ar[None, :],
                               bids[:, None], float("-inf"))     # (N, N)
        win_bid = torch.amax(col_bids, dim=0)
        win_row = torch.argmax(col_bids, dim=0)
        contested = win_bid > float("-inf")
        prices = torch.where(contested, win_bid, prices)
        # evict the previous owners of contested columns
        old_owner = torch.where(contested, c2r, -1)
        evicted = (old_owner[None, :] == ar[:, None]).any(dim=1)
        r2c = torch.where(evicted, -1, r2c)
        c2r = torch.where(contested, win_row, c2r)
        # each row bids on one column, so winners are distinct rows
        won = (win_row[None, :] == ar[:, None]) & contested[None, :]
        r2c = torch.where(won.any(dim=1), torch.argmax(won.to(torch.int8),
                                                       dim=1), r2c)
        it += 1
    return r2c.to(torch.int32)


def greedy_assign(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Greedy min-cost matching: repeatedly take the globally cheapest
    unassigned (row, col) pair."""
    t, d = cost.shape
    dev = cost.device
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(d, device=dev)[None, :]
    c = cost.to(torch.float32)
    r2c = torch.full((t,), -1, dtype=torch.int32, device=dev)
    it = 0
    while it < n_iters and bool(c.min() < INF_COST):
        flat = torch.argmin(c)
        i, j = flat // d, flat % d
        ok = c[i, j] < INF_COST
        r2c = torch.where(ok & (rows[:, 0] == i), j.to(torch.int32), r2c)
        c = torch.where(ok & ((rows == i) | (cols == j)), INF_COST, c)
        it += 1
    return r2c


def greedy_assign_rounds(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Greedy matching by mutual-minimum rounds: each round accepts every
    pair that is the argmin of both its row and its column, then removes
    those rows and columns. Same matching as `greedy_assign`."""
    t, d = cost.shape
    dev = cost.device
    ar_t = torch.arange(t, device=dev)
    ar_d = torch.arange(d, device=dev)
    c = cost.to(torch.float32)
    r2c = torch.full((t,), -1, dtype=torch.int32, device=dev)
    it = 0
    while it < n_iters and bool(c.min() < INF_COST):
        row_best = torch.argmin(c, dim=1)
        col_best = torch.argmin(c, dim=0)
        row_min = torch.amin(c, dim=1)
        mutual = (col_best[row_best] == ar_t) & (row_min < INF_COST)
        r2c = torch.where(mutual, row_best.to(torch.int32), r2c)
        col_hit = (mutual[:, None] & (row_best[:, None] == ar_d[None, :])
                   ).any(dim=0)
        c = torch.where(mutual[:, None] | col_hit[None, :], INF_COST, c)
        it += 1
    return r2c


def gated_matches(cost: torch.Tensor, row_valid: torch.Tensor,
                  col_valid: torch.Tensor, gate: float,
                  method: str = "auction") -> torch.Tensor:
    """Assignment + gate rejection. Returns col_of_row (T,) int32, -1 =
    unmatched; matches above `gate` or on invalid rows/cols are rejected."""
    t, d = cost.shape
    masked = torch.where(row_valid[:, None] & col_valid[None, :], cost,
                         INF_COST)
    if method == "greedy":
        r2c = greedy_assign(masked, n_iters=min(t, d))
    elif method == "greedy_rounds":
        r2c = greedy_assign_rounds(masked, n_iters=min(t, d))
    else:
        n = max(t, d)
        # distinct sub-gate offsets on forbidden/pad cells so the auction's
        # pad region settles at once; valid (< INF) cells are untouched
        ii = torch.arange(n, device=cost.device)[:, None]
        jj = torch.arange(n, device=cost.device)[None, :]
        tiebreak = torch.remainder(ii - jj, n).to(torch.float32) / n
        sq = INF_COST + tiebreak
        sub = sq[:t, :d]
        sq[:t, :d] = torch.where(masked >= INF_COST,
                                 sub + masked - INF_COST, masked)
        r2c = auction_assign(sq)[:t]
    matched_cost = masked.gather(
        1, torch.clamp(r2c, 0, d - 1).to(torch.int64)[:, None])[:, 0]
    ok = (r2c >= 0) & (r2c < d) & (matched_cost < gate) & row_valid
    return torch.where(ok, r2c, -1).to(torch.int32)
