"""IVF approximate nearest-neighbour search (the faiss IVF role).

Counterpart of `reid_tpu/ops/ivf.py` (ref `reid/faiss_utils.py:158-181`,
GpuIndexIVFFlat with nlist/nprobe):

  * build: a k-means coarse quantizer (`ops.kmeans`) over the gallery,
    then a host reorder of the gallery into equal-size padded cluster
    buckets (C, B, D). Lists larger than `max_imbalance` times the average
    are re-split on the host with a small 2-means seeded by
    `np.random.default_rng(0)`, the JAX package's own code, so both
    packages bucket alike from the same k-means labels.
  * search: query -> centroid distances (one product), the nprobe nearest
    lists per query, one gather of the candidate rows of a block of
    queries, exact distances and a stable sort over the candidates. Pad
    rows carry +inf; columns past the candidates are -1. Exact when
    nprobe covers every list.

Plain PyTorch on the device, as the JAX package leaves it to XLA: the
gather is data movement and the two products go to `torch.matmul` (K6 is
the dense path's kernel).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.timing import StageTimer
from .kmeans import kmeans

_GATHER_BYTES = int(1e9)     # bound of one block's gathered candidates


class IVFIndex(NamedTuple):
    centroids: torch.Tensor   # (C, D) f32
    buckets: torch.Tensor     # (C, B, D) gallery rows, padded
    bucket_ids: torch.Tensor  # (C, B) int64 original row ids; -1 = pad
    n: int                    # true gallery size


def _resplit(g: np.ndarray, groups: list, nlist: int,
             max_imbalance: float) -> list:
    """Halve the largest list with a host 2-means until every list holds
    at most `max_imbalance` times the average (at most 4 * nlist lists);
    warns where balance cannot be reached. `reid_tpu/ops/ivf.py:build_ivf`
    step for step."""
    target = max(max_imbalance * len(g) / max(nlist, 1), 1.0)
    rng = np.random.default_rng(0)
    unsplittable: set = set()
    while len(groups) < 4 * nlist:
        big = max(range(len(groups)), key=lambda i: len(groups[i]))
        if len(groups[big]) <= target or big in unsplittable:
            break
        idx = groups[big]
        pts = g[idx].astype(np.float64)
        seeds = pts[rng.choice(len(pts), 2, replace=False)]
        for _ in range(8):
            assign = (((pts[:, None, :] - seeds[None]) ** 2).sum(-1)
                      .argmin(1))
            if assign.min() == assign.max():
                break
            seeds = np.stack([pts[assign == j].mean(0) for j in (0, 1)])
        if assign.min() == assign.max():  # identical rows: cannot split
            unsplittable.add(big)
            continue
        groups[big] = idx[assign == 0]
        groups.append(idx[assign == 1])
        unsplittable.discard(big)
    sizes = np.asarray([len(gr) for gr in groups])
    if sizes.max() > target:
        warnings.warn(
            f"build_ivf: largest list holds {int(sizes.max())} of {len(g)} "
            f"rows after re-splitting (> {max_imbalance}x the n/nlist "
            "average); ivf_topk will gather near-brute-force volumes - "
            "consider brute-force topk_neighbors for this gallery")
    return groups


def build_ivf(gallery: torch.Tensor, nlist: int = 64, iters: int = 25,
              max_imbalance: float = 4.0,
              generator: Optional[torch.Generator] = None,
              timing: Optional[dict] = None) -> IVFIndex:
    """Train the coarse quantizer on the gallery's device and bucket the
    gallery (host reorder). The index may hold more than `nlist` lists
    after re-splitting: probe `len(index.centroids)` for an exact search.
    `generator` draws k-means' initial rows; `timing` gets
    the seconds of kmeans and buckets."""
    stages = StageTimer(timing, gallery.device)
    labels, centroids = kmeans(gallery, nlist, iters=iters,
                               generator=generator)
    stages.mark("kmeans")
    labels = labels.cpu().numpy()
    g = gallery.detach().cpu().numpy()
    groups = _resplit(g, [np.nonzero(labels == c)[0] for c in range(nlist)],
                      nlist, max_imbalance)
    b = max(max(len(gr) for gr in groups), 1)
    c, d = len(groups), g.shape[1]
    buckets = np.zeros((c, b, d), g.dtype)
    ids = np.full((c, b), -1, np.int64)
    cents = np.zeros((c, d), np.float32)
    cent0 = centroids.cpu().numpy()
    for ci, idx in enumerate(groups):
        buckets[ci, :len(idx)] = g[idx]
        ids[ci, :len(idx)] = idx
        cents[ci] = g[idx].mean(0) if len(idx) else cent0[min(ci, nlist - 1)]
    dev = gallery.device
    index = IVFIndex(torch.from_numpy(cents).to(dev),
                     torch.from_numpy(buckets).to(dev),
                     torch.from_numpy(ids).to(dev), g.shape[0])
    stages.mark("buckets")
    return index


def ivf_topk(index: IVFIndex, query: torch.Tensor, k: int, nprobe: int = 8,
             block_q: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest gallery rows per query (squared Euclidean, ascending):
    (dists (Q, k) f32, idx (Q, k) int64) with idx into the original
    gallery order; approximate unless nprobe covers every list. A block
    of queries gathers at most about 1 GB of candidate rows."""
    q, d = query.shape
    c, b, _ = index.buckets.shape
    nprobe = min(nprobe, c)
    per_query_bytes = 4 * nprobe * b * d
    block_q = max(8, min(block_q, _GATHER_BYTES // max(per_query_bytes, 1)))
    cent = index.centroids.to(torch.float32)
    cc = torch.sum(cent * cent, dim=1)
    kk = min(k, nprobe * b)
    dists, idxs = [], []
    for s in range(0, q, block_q):
        qf = query[s:s + block_q].to(torch.float32)
        qq = torch.sum(qf * qf, dim=1, keepdim=True)
        # coarse: the nprobe nearest lists, ties to the lower list
        cd = qq + cc[None, :] - 2.0 * (qf @ cent.T)
        probe = torch.sort(cd, dim=1, stable=True)[1][:, :nprobe]
        cand = index.buckets[probe].reshape(qf.shape[0], nprobe * b, d).to(
            torch.float32)
        cand_ids = index.bucket_ids[probe].reshape(qf.shape[0], nprobe * b)
        # fine: exact distances to the gathered candidates
        dist = qq + torch.sum(cand * cand, dim=2) - 2.0 * torch.bmm(
            cand, qf[:, :, None])[:, :, 0]
        del cand
        dist = torch.where(cand_ids >= 0, dist, float("inf"))
        dd, pos = torch.sort(dist, dim=1, stable=True)
        dd, pos = dd[:, :kk], pos[:, :kk]
        idx = cand_ids.gather(1, pos)
        if k > kk:   # tiny-bucket corner: pad out to k
            pad = k - kk
            dd = torch.cat([dd, dd.new_full((dd.shape[0], pad),
                                            float("inf"))], 1)
            idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], 1)
        dists.append(dd)
        idxs.append(idx)
    if not dists:
        empty = torch.empty((0, k), device=query.device)
        return empty, empty.to(torch.int64)
    return torch.cat(dists), torch.cat(idxs)
