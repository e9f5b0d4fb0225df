"""Linear assignment on the device, batched over streams.

Counterpart of `reid_tpu/tracking/assignment.py`. Every function takes a
leading stream axis (S, ...), which the JAX package gets from `jax.vmap`;
a 2-D input is one stream and runs the same code at S = 1. The JAX package
runs the early-exit loops as `lax.while_loop`s on the device. Here each
loop is a `cond` and a `body` that `device_loop` drives in one of two
forms: in eager PyTorch, which has no device-side loop, each round reads
its exit condition on the host (one small synchronisation a round for all
S streams); under `torch.export` the same functions become one
`while_loop` node of the exported graph, so an exported chunk of the
tracker holds no host read. A round runs while any stream has work, and a
stream that has finished is frozen by a mask, so each stream's matching is
exactly that of its own run. The matchings are the JAX ones: ties break to
the first index, as `argmin` / `argmax` do in both frameworks.
"""

from __future__ import annotations

import contextlib
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


def device_loop(cond, body, carry, max_iters):
    """Runs `carry = body(*carry)` while fewer than `max_iters` rounds have
    run and `cond(*carry)` (a one-element bool tensor; None: always) holds;
    returns the last carry, a tuple of tensors. `body` returns new tensors
    and never one of its arguments.

    Eager: a Python loop that reads `cond` on the host once a round
    (`host_read`, counted), and a tensor `max_iters` once before the
    first. Under `torch.export`: one `while_loop` whose carry adds an
    int64 round counter, `max_iters` staying a tensor, so the exported
    graph reads nothing on the host. (In eager mode `while_loop` compiles
    its functions with Dynamo on every call, so the eager path keeps its
    host-read loop.)"""
    carry = tuple(carry)
    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop

        dev = carry[0].device
        # a Python int bound would be lifted as a graph input of a nested
        # loop's functions, which the exported program's verifier refuses
        bound = max_iters if isinstance(max_iters, torch.Tensor) else \
            torch.full((), max_iters, dtype=torch.int64, device=dev)

        def go(it, *xs):
            more = it < bound
            return more if cond is None else more & cond(*xs)

        def step(it, *xs):
            return (it + 1, *body(*xs))

        it0 = torch.zeros((), dtype=torch.int64, device=dev)
        # export traces the functions with Dynamo, which it lets take every
        # size as symbolic; the bodies are written for static shapes (a
        # symbolic one does not line up the auction's padded slices). A
        # loop nested in another loop's functions inherits the setting,
        # and Dynamo refuses a config patch inside a traced function.
        static = contextlib.nullcontext() \
            if torch.compiler.is_dynamo_compiling() else \
            torch._dynamo.config.patch(assume_static_by_default=True,
                                       automatic_dynamic_shapes=False)
        with static:
            return tuple(while_loop(go, step, (it0, *carry))[1:])
    if isinstance(max_iters, torch.Tensor):
        max_iters = host_read(max_iters)
    it = 0
    while it < max_iters and (cond is None or host_read(cond(*carry))):
        carry = tuple(body(*carry))
        it += 1
    return carry


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
    ar = torch.arange(n, device=dev)

    def unassigned_left(prices, r2c, c2r):
        return (r2c < 0).any()

    def bid(prices, r2c, c2r):
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
        return prices, r2c, c2r

    _, r2c, _ = device_loop(unassigned_left, bid, (
        torch.zeros((s, n), device=dev),
        torch.full((s, n), -1, dtype=torch.int64, device=dev),
        torch.full((s, n), -1, dtype=torch.int64, device=dev)), max_iters)
    return r2c.to(torch.int32)


def _pair_left(c, r2c):
    """The greedy loops' condition: some stream has a pair below INF_COST."""
    return c.min() < INF_COST


@_streams
def greedy_assign(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Greedy min-cost matching: repeatedly take each stream's globally
    cheapest unassigned (row, col) pair. cost (S, T, D) -> (S, T) int32."""
    s, t, d = cost.shape
    dev = cost.device
    rows = torch.arange(t, device=dev)[None, :, None]
    cols = torch.arange(d, device=dev)[None, None, :]

    def take_cheapest(c, r2c):
        flat = torch.argmin(c.reshape(s, t * d), dim=1)          # (S,)
        i, j = (flat // d)[:, None, None], (flat % d)[:, None, None]
        # a stream with no pair left is frozen
        ok = c.reshape(s, t * d).gather(1, flat[:, None])[:, :, None] \
            < INF_COST                                           # (S, 1, 1)
        r2c = torch.where(ok[:, 0] & (rows[:, :, 0] == i[:, 0]),
                          j[:, 0].to(torch.int32), r2c)
        c = torch.where(ok & ((rows == i) | (cols == j)), INF_COST, c)
        return c, r2c

    return device_loop(_pair_left, take_cheapest, (
        cost.to(torch.float32),
        torch.full((s, t), -1, dtype=torch.int32, device=dev)), n_iters)[1]


@_streams
def greedy_assign_rounds(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Greedy matching by mutual-minimum rounds: each round accepts every
    pair that is the argmin of both its row and its column, then removes
    those rows and columns. Same matching as `greedy_assign`."""
    s, t, d = cost.shape
    dev = cost.device
    ar_t = torch.arange(t, device=dev)
    ar_d = torch.arange(d, device=dev)

    def take_mutual(c, r2c):
        row_best = torch.argmin(c, dim=2)                        # (S, T)
        col_best = torch.argmin(c, dim=1)                        # (S, D)
        row_min = torch.amin(c, dim=2)
        # a finished stream has no row below INF_COST: no pair is mutual
        mutual = (col_best.gather(1, row_best) == ar_t) & (row_min < INF_COST)
        r2c = torch.where(mutual, row_best.to(torch.int32), r2c)
        col_hit = (mutual[:, :, None] & (row_best[:, :, None] == ar_d)
                   ).any(dim=1)                                  # (S, D)
        c = torch.where(mutual[:, :, None] | col_hit[:, None, :], INF_COST, c)
        return c, r2c

    return device_loop(_pair_left, take_mutual, (
        cost.to(torch.float32),
        torch.full((s, t), -1, dtype=torch.int32, device=dev)), n_iters)[1]


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
