"""Linear assignment on the device, batched over streams.

Counterpart of `reid_tpu/tracking/assignment.py`. Every function takes a
leading stream axis (S, ...), which the JAX package gets from `jax.vmap`;
a 2-D input is one stream and runs the same code at S = 1. The JAX package
runs the early-exit loops as `lax.while_loop`s on the device; eager PyTorch
has no device-side loop, so each round here reads its exit condition on the
host: one small synchronisation a round for all S streams. A round runs
while any stream has work, and a stream that has finished is frozen by a
mask, so each stream's matching is exactly that of its own run. The
matchings are the JAX ones: ties break to the first index, as `argmin` /
`argmax` do in both frameworks.
"""

from __future__ import annotations

import functools

import torch

INF_COST = 10.0

# host reads of the tracker's loops since the last reset, all streams
# together: a run reads them to show one read a round, not one a stream
_HOST_READS = [0]


def host_read(x: torch.Tensor) -> float:
    """The value of a one-element tensor on the host, counted."""
    _HOST_READS[0] += 1
    return x.item()


def host_reads() -> int:
    return _HOST_READS[0]


def reset_host_reads() -> None:
    _HOST_READS[0] = 0


def _streams(fn):
    """Runs `fn`, written for a leading stream axis, on a 2-D (one-stream)
    `cost` too, by adding the axis and taking it off the result."""
    @functools.wraps(fn)
    def run(cost, *args, **kwargs):
        if cost.dim() == 3:
            return fn(cost, *args, **kwargs)
        args = [a[None] if isinstance(a, torch.Tensor) else a for a in args]
        return fn(cost[None], *args, **kwargs)[0]
    return run


def _top2(values: torch.Tensor):
    """Per-row best and second-best values and the best index; ties go to
    the lower index, as `lax.top_k` keeps them."""
    best = torch.argmax(values, dim=-1)
    top1 = values.gather(-1, best[..., None])[..., 0]
    rest = values.scatter(-1, best[..., None], float("-inf"))
    top2 = torch.amax(rest, dim=-1)
    return top1, top2, best


@_streams
def auction_assign(cost: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Min-cost perfect matching on square (S, N, N) matrices (Bertsekas
    parallel auction). Returns row_to_col (S, N) int32. The iteration cap
    depends on N alone, so it is each stream's own."""
    s, n = cost.shape[0], cost.shape[-1]
    dev = cost.device
    benefit = -cost.to(torch.float32)
    max_iters = int(4 * n * (2 * INF_COST / eps + n))
    prices = torch.zeros((s, n), device=dev)
    r2c = torch.full((s, n), -1, dtype=torch.int64, device=dev)
    c2r = torch.full((s, n), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(n, device=dev)
    it = 0
    while it < max_iters and host_read((r2c < 0).any()):
        unassigned = r2c < 0                                     # (S, N)
        live = unassigned.any(dim=1, keepdim=True)               # (S, 1)
        values = benefit - prices[:, None, :]
        top1, top2, best_col = _top2(values)
        bid_amount = top1 - top2 + eps
        bids = torch.where(unassigned, prices.gather(1, best_col)
                           + bid_amount, float("-inf"))
        # for each column, the highest bidder among unassigned rows wins
        col_bids = torch.where(best_col[:, :, None] == ar,
                               bids[:, :, None], float("-inf"))  # (S, N, N)
        win_bid = torch.amax(col_bids, dim=1)
        win_row = torch.argmax(col_bids, dim=1)
        contested = (win_bid > float("-inf")) & live
        prices = torch.where(contested, win_bid, prices)
        # evict the previous owners of contested columns
        old_owner = torch.where(contested, c2r, -1)
        evicted = (old_owner[:, None, :] == ar[:, None]).any(dim=2)
        r2c = torch.where(evicted, -1, r2c)
        c2r = torch.where(contested, win_row, c2r)
        # each row bids on one column, so winners are distinct rows
        won = (win_row[:, None, :] == ar[:, None]) & contested[:, None, :]
        r2c = torch.where(won.any(dim=2), torch.argmax(won.to(torch.int8),
                                                       dim=2), r2c)
        it += 1
    return r2c.to(torch.int32)


@_streams
def greedy_assign(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Greedy min-cost matching: repeatedly take each stream's globally
    cheapest unassigned (row, col) pair. cost (S, T, D) -> (S, T) int32."""
    s, t, d = cost.shape
    dev = cost.device
    rows = torch.arange(t, device=dev)[None, :, None]
    cols = torch.arange(d, device=dev)[None, None, :]
    c = cost.to(torch.float32)
    r2c = torch.full((s, t), -1, dtype=torch.int32, device=dev)
    it = 0
    while it < n_iters and host_read(c.min() < INF_COST):
        flat = torch.argmin(c.reshape(s, t * d), dim=1)          # (S,)
        i, j = (flat // d)[:, None, None], (flat % d)[:, None, None]
        # a stream with no pair left is frozen
        ok = c.reshape(s, t * d).gather(1, flat[:, None])[:, :, None] \
            < INF_COST                                           # (S, 1, 1)
        r2c = torch.where(ok[:, 0] & (rows[:, :, 0] == i[:, 0]),
                          j[:, 0].to(torch.int32), r2c)
        c = torch.where(ok & ((rows == i) | (cols == j)), INF_COST, c)
        it += 1
    return r2c


@_streams
def greedy_assign_rounds(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Greedy matching by mutual-minimum rounds: each round accepts every
    pair that is the argmin of both its row and its column, then removes
    those rows and columns. Same matching as `greedy_assign`."""
    s, t, d = cost.shape
    dev = cost.device
    ar_t = torch.arange(t, device=dev)
    ar_d = torch.arange(d, device=dev)
    c = cost.to(torch.float32)
    r2c = torch.full((s, t), -1, dtype=torch.int32, device=dev)
    it = 0
    while it < n_iters and host_read(c.min() < INF_COST):
        row_best = torch.argmin(c, dim=2)                        # (S, T)
        col_best = torch.argmin(c, dim=1)                        # (S, D)
        row_min = torch.amin(c, dim=2)
        # a finished stream has no row below INF_COST: no pair is mutual
        mutual = (col_best.gather(1, row_best) == ar_t) & (row_min < INF_COST)
        r2c = torch.where(mutual, row_best.to(torch.int32), r2c)
        col_hit = (mutual[:, :, None] & (row_best[:, :, None] == ar_d)
                   ).any(dim=1)                                  # (S, D)
        c = torch.where(mutual[:, :, None] | col_hit[:, None, :], INF_COST, c)
        it += 1
    return r2c


@_streams
def gated_matches(cost: torch.Tensor, row_valid: torch.Tensor,
                  col_valid: torch.Tensor, gate: float,
                  method: str = "auction") -> torch.Tensor:
    """Assignment + gate rejection. cost (S, T, D), row_valid (S, T),
    col_valid (S, D) -> col_of_row (S, T) int32, -1 = unmatched; matches
    above `gate` or on invalid rows/cols are rejected."""
    s, t, d = cost.shape
    masked = torch.where(row_valid[:, :, None] & col_valid[:, None, :], cost,
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
        sq = (INF_COST + tiebreak).expand(s, n, n).clone()
        sub = sq[:, :t, :d]
        sq[:, :t, :d] = torch.where(masked >= INF_COST,
                                    sub + masked - INF_COST, masked)
        r2c = auction_assign(sq)[:, :t]
    matched_cost = masked.gather(
        2, torch.clamp(r2c, 0, d - 1).to(torch.int64)[:, :, None])[:, :, 0]
    ok = (r2c >= 0) & (r2c < d) & (matched_cost < gate) & row_valid
    return torch.where(ok, r2c, -1).to(torch.int32)
