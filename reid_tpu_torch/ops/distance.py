"""Pairwise distances and the top-k gallery search.

Counterpart of `reid_tpu/ops/distance.py`. Two kernels, each with its plain
PyTorch version beside it:

  * `sqeuclidean` (K6, `csrc/distance.cu`): max(|x|^2 + |y|^2 - 2 x.y, 0)
    in full f32, a pipelined SIMT GEMM over transposed, zero-padded copies
    of both operands; `sqeuclidean_plain` is the norms plus one matmul, as
    `reid_tpu/ops/distance.py:_jnp_sqeuclidean` computes it.
  * `l1` (K7, `csrc/distance.cu`): sum_k |x - y|, the Jaccard min-sum of
    `ops/rerank.py`; `l1_plain` is the blocked broadcast sum of
    `reid_tpu/ops/distance.py:pairwise_l1`'s fallback.

A wrapper computes its plain version on a CPU tensor and launches its kernel
on a CUDA tensor; nothing else chooses. The JAX package switches its
squared-Euclidean kernel off by default after a TPU measurement; on the card
the port always runs both kernels.

`topk_neighbors` is blocked over queries, so only (block_q, N) slabs exist
at once, and orders each row with a stable sort: ties come lowest index
first, as `jax.lax.top_k` returns them. No query row is padded.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _lib

NAME_SQ = "sqeuclidean"
NAME_L1 = "l1"
_L1_BUDGET = 1 << 26     # elements of one |x - y| block of `l1_plain`
_L1_ROWS = 128           # rows of x per block of `l1_plain`
# K6's tile (rows of x, rows of y) and D chunk: its operands are copied
# transposed and zero-padded to whole tiles and chunks (csrc/distance.cu)
_SQ_TILE = (128, 144, 16)


def _ceil_to(v: int, k: int) -> int:
    return -(-v // k) * k


def sqeuclidean_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D), (N, D) -> (M, N) f32 max(|x|^2 + |y|^2 - 2 x.y, 0). Full f32
    only while the caller keeps TF32 off, as the entry points do."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    xx = torch.sum(xf * xf, dim=-1, keepdim=True)
    yy = torch.sum(yf * yf, dim=-1, keepdim=True)
    return torch.clamp(xx + yy.T - 2.0 * (xf @ yf.T), min=0.0)


def l1_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D), (N, D) -> (M, N) f32 sum_k |x - y|: blocks of `_L1_ROWS`
    rows of x, and blocks of D wherever one (rows, N, D) broadcast would
    pass `_L1_BUDGET` elements."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    m, d = xf.shape
    n = yf.shape[0]
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    bm = max(1, min(_L1_ROWS, m, _L1_BUDGET // max(n, 1)))
    bd = max(1, min(d, _L1_BUDGET // max(bm * n, 1)))
    for r in range(0, m, bm):
        for k in range(0, d, bd):
            diff = xf[r:r + bm, None, k:k + bd] - yf[None, :, k:k + bd]
            out[r:r + bm] += diff.abs_().sum(-1)
    return out


def _check(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}, {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"{name} takes (M, D) and (N, D), got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if x.device != y.device or not x.is_contiguous() \
            or not y.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors on one device")


def sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K6: (M, D) x (N, D) f32 -> (M, N) f32 squared Euclidean distances."""
    if x.device.type == "cpu":
        return sqeuclidean_plain(x, y)
    _check(NAME_SQ, x, y)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    mp, np_, dp = (_ceil_to(m, _SQ_TILE[0]), _ceil_to(n, _SQ_TILE[1]),
                   _ceil_to(d, _SQ_TILE[2]))
    xt = torch.empty((dp, mp), dtype=torch.float32, device=x.device)
    yt = torch.empty((dp, np_), dtype=torch.float32, device=x.device)
    xx = torch.empty(m, dtype=torch.float32, device=x.device)
    yy = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _lib.function("distance", "reid_sqeuclidean", [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _lib.check(fn(x.data_ptr(), y.data_ptr(), xt.data_ptr(), yt.data_ptr(),
                  xx.data_ptr(), yy.data_ptr(), out.data_ptr(), m, n, d, mp,
                  np_, dp, _lib.stream_of(x)), NAME_SQ)
    _lib.count_launch(NAME_SQ, (d,))
    return out


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K7: (M, D), (N, D) f32 -> (M, N) f32 pairwise L1 distances."""
    if x.device.type == "cpu":
        return l1_plain(x, y)
    _check(NAME_L1, x, y)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _lib.function("distance", "reid_l1", [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _lib.check(fn(_lib.ptr(x), _lib.ptr(y), _lib.ptr(out), m, n, d,
                  _lib.stream_of(x)), NAME_L1)
    _lib.count_launch(NAME_L1, (d,))
    return out


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def pairwise_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance matrix (M, N), float32."""
    return sqeuclidean(_f32(x), _f32(y))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def pairwise_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity: half the squared distance of the normalized
    rows."""
    return 0.5 * pairwise_sqeuclidean(_l2n(x), _l2n(y))


def pairwise_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 (cityblock) distance matrix (M, N), float32."""
    return l1(_f32(x), _f32(y))


def topk_neighbors(query: torch.Tensor, gallery: torch.Tensor, k: int,
                   block_q: int = 1024, self_first: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest gallery rows per query by squared Euclidean distance:
    (dists (Q, k) ascending, idx (Q, k) int64), blocked over `block_q`
    queries. With `self_first`, query row i is gallery row self_first + i
    and is ranked first whatever its distance (which then reads -inf)."""
    if k > gallery.shape[0]:
        raise ValueError(f"k = {k} > {gallery.shape[0]} gallery rows")
    dists, idxs = [], []
    for s in range(0, query.shape[0], block_q):
        dist = pairwise_sqeuclidean(query[s:s + block_q], gallery)
        if self_first is not None:
            i = torch.arange(dist.shape[0], device=dist.device)
            dist[i, self_first + s + i] = float("-inf")
        vals, idx = torch.sort(dist, dim=1, stable=True)
        del dist
        dists.append(vals[:, :k].clone())
        idxs.append(idx[:, :k].clone())
        del vals, idx
    if not dists:
        empty = torch.empty((0, k), device=query.device)
        return empty, empty.to(torch.int64)
    return torch.cat(dists), torch.cat(idxs)
