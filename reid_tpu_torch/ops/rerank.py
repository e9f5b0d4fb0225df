"""k-reciprocal Jaccard re-ranking (Zhong et al., CVPR'17).

Counterpart of `reid_tpu/ops/rerank.py` (`compute_jaccard_distance`,
`compute_jaccard_distance_ivf`, `_jaccard_from_rank`, `_minsum_topk_rows`,
`jaccard_distance`, and `compute_jaccard_distance_sharded`, the mesh
variant over a `parallel.Mesh`). The steps are the reference's:

  1. initial ranking       -> `topk_neighbors` (kernel K6), or the IVF
                              approximate ranking (`ops/ivf.py`)
  2. k-reciprocal sets     -> boolean scatter F, R = F & F^T
  3. local query expansion -> one 0/1 matmul (the 2/3-overlap rule)
  4. V encoding            -> masked softmax of 2*sim over the expansion set
  5. query expansion (k2)  -> the mean of each row's k2 first neighbours
  6. Jaccard min-sum       -> rows of V sum to 1, so
                              sum_k min(V_i, V_j) = 1 - L1(V_i, V_j) / 2:
                              one pairwise L1 (kernel K7), or the top-S
                              sparse gather when asked and exact
  7. J = 1 - tm / (2 - tm), clipped at 0

Eager PyTorch keeps every tensor alive that a name still holds, where XLA
reused buffers: at N = 23,100 one (N, N) f32 matrix is 2.1 GB. So each
intermediate is dropped as soon as the next step has read it, and the last
steps work in place.

The two 0/1 overlap products are exact in any input precision with an f32
accumulator (inputs 0 or 1, sums at most k1): on the card they take f16
operands, which reach the tensor cores; on the CPU f32. Step 5 is the
reference's averaging matmul A_{k2} @ V computed as the sum of the k2
gathered rows of V, in ascending neighbour index (the order of a dot over
the row of A); it needs no (N, N) A and no N^3 product.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.timing import StageTimer
from .distance import pairwise_l1, topk_neighbors

_MINSUM_ROWS = 128       # rows per gather block of the top-S min-sum


def _topk_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean (rows, n) membership mask from top-k index rows (rows, k)."""
    m = torch.zeros((idx.shape[0], n), dtype=torch.bool, device=idx.device)
    return m.scatter_(1, idx, True)


def _minsum_topk_rows(v_rows: torch.Tensor, v_all: torch.Tensor, s: int
                      ) -> torch.Tensor:
    """tm[i, j] = sum_k min(v_rows[i, k], v_all[j, k]) over the top-S
    support of each v_rows row: per block of `_MINSUM_ROWS` rows, the S
    support columns are gathered from v_all, (N, rows, S), and reduced with
    a broadcast min. Exact while every row has at most S nonzeros."""
    m, n = v_rows.shape[0], v_all.shape[0]
    val, idx = torch.topk(v_rows, s, dim=1)
    out = torch.empty((m, n), dtype=torch.float32, device=v_rows.device)
    for r in range(0, m, _MINSUM_ROWS):
        vb, ib = val[r:r + _MINSUM_ROWS], idx[r:r + _MINSUM_ROWS]
        g = v_all[:, ib.reshape(-1)].reshape(n, vb.shape[0], s)
        out[r:r + _MINSUM_ROWS] = torch.minimum(vb[None], g).sum(-1).T
        del g
    return out


def _v_rows(feats: torch.Tensor, initial_rank: torch.Tensor, k1: int,
           r0: int, m: int, stages: StageTimer) -> torch.Tensor:
    """Steps 2-4 for the rows [r0, r0 + m): the (m, N) rows of V, each
    summing to 1, from unit-norm features and the whole (N, k1) ranking;
    marks masks, overlap and v on `stages`. Every rank of the sharded
    path holds the (N, N) half-size reciprocal masks; the rest is (m, N).
    With r0 = 0 and m = N it is the dense single-device step."""
    n = feats.shape[0]
    k_half = int(round(k1 / 2))          # Python's round: half to even
    dev = feats.device
    mm = torch.float16 if dev.type == "cuda" else torch.float32

    # k-reciprocal masks: R[i,j] = j in top(i) and i in top(j); the
    # transpose half of R's rows is scattered from the rankings that
    # hold one of these rows
    f = _topk_mask(initial_rank[:, :k_half + 1], n)
    r_half = f & f.T
    del f
    r_full = _topk_mask(initial_rank[r0:r0 + m], n)
    ft = torch.zeros((m, n), dtype=torch.bool, device=dev)
    j = torch.arange(n, device=dev)[:, None].expand(n, k1)
    own = (initial_rank >= r0) & (initial_rank < r0 + m)
    ft[initial_rank[own] - r0, j[own]] = True
    r_full &= ft
    del ft, j, own
    stages.mark("masks")

    # local expansion: candidate c of R[i] contributes R_h[c] when
    # |R_h[c] & R[i]| > 2/3 |R_h[c]|
    rh = r_half.to(mm)
    sizes_h = r_half.sum(1).to(torch.float32)
    del r_half
    overlap = r_full.to(mm) @ rh.T                        # (i, c), exact
    thresh = torch.tensor(2.0 / 3.0, dtype=torch.float32, device=dev) \
        * sizes_h
    cond = r_full & (overlap > thresh[None, :])
    del overlap
    grow = cond.to(mm) @ rh
    del cond, rh
    expansion = r_full | (grow > 0)
    del grow, r_full
    stages.mark("overlap")

    # V: softmax of 2*sim over the expansion set; -dist = 2*sim - 2 and
    # the constant cancels inside the softmax
    logits = feats[r0:r0 + m] @ feats.T
    logits.mul_(2.0).masked_fill_(~expansion, float("-inf"))
    del expansion
    v = torch.softmax(logits, dim=1)
    del logits
    stages.mark("v")
    return v


def _query_expansion(v: torch.Tensor, initial_rank: torch.Tensor,
                     k2: int) -> torch.Tensor:
    """Step 5: each row of V replaced by the mean of the V rows of its k2
    first neighbours, summed in ascending neighbour index, then
    renormalized (the min-sum identity needs row sums of exactly 1).
    Consumes `v` where it makes a new tensor."""
    if k2 == 1:
        return v
    nb = torch.sort(initial_rank[:, :k2], dim=1).values
    acc = v.index_select(0, nb[:, 0])
    for c in range(1, k2):
        acc += v.index_select(0, nb[:, c])
    del v
    acc.div_(k2)
    return acc.div_(acc.sum(1, keepdim=True))


def _jaccard_from_rank(feats: torch.Tensor, initial_rank: torch.Tensor,
                       k1: int, k2: int, sparse_s: Optional[int] = None,
                       timing: Optional[dict] = None) -> torch.Tensor:
    """Shared Jaccard body given unit-norm features + top-k1 ranking. With
    `timing`, the seconds of its steps go there: masks, overlap (the two
    0/1 products), v, expansion (k2), minsum (with the final J)."""
    stages = StageTimer(timing, feats.device)
    v = _v_rows(feats, initial_rank, k1, 0, feats.shape[0], stages)
    v = _query_expansion(v, initial_rank, k2)
    stages.mark("expansion")

    # min-sum: the L1 identity, or the top-S sparse gather while it is
    # exact (every V row with at most S nonzeros; one host read)
    jac = _minsum_jaccard(v, v, sparse_s)
    del v
    stages.mark("minsum")
    return jac


def _minsum_jaccard(v_rows: torch.Tensor, v_all: torch.Tensor,
                    sparse_s: Optional[int]) -> torch.Tensor:
    """Steps 6-7 for a block of rows: the min-sum against every row of V,
    by the L1 identity (K7 on the (rows, N) slab) or the top-S sparse
    gather while it is exact for these rows (at most S nonzeros in each;
    one host read), then J = max(1 - tm / (2 - tm), 0)."""
    n = v_all.shape[0]
    if sparse_s is not None and sparse_s < n and \
            int((v_rows > 0.0).sum(1).max()) <= sparse_s:
        tm = _minsum_topk_rows(v_rows, v_all, sparse_s)
    else:
        tm = pairwise_l1(v_rows, v_all).mul_(-0.5).add_(1.0)
    jac = 2.0 - tm
    torch.div(tm, jac, out=jac)
    return jac.neg_().add_(1.0).clamp_(min=0.0)


def compute_jaccard_distance(features: torch.Tensor, k1: int = 20,
                             k2: int = 6, sparse_s: Optional[int] = None,
                             timing: Optional[dict] = None) -> torch.Tensor:
    """Jaccard distance matrix (N, N) float32 (ref faiss_utils.py:149-244).
    `sparse_s` enables the top-S min-sum, exact whenever each V row has at
    most S nonzeros and otherwise replaced by the dense path."""
    feats = features.to(torch.float32)
    feats = feats / torch.clamp(torch.linalg.norm(feats, dim=1, keepdim=True),
                                min=1e-12)
    # k1 columns with self first: the reference's faiss convention
    stages = StageTimer(timing, feats.device)
    _, initial_rank = topk_neighbors(feats, feats, k=k1)
    stages.mark("topk")
    return _jaccard_from_rank(feats, initial_rank, k1=k1, k2=k2,
                              sparse_s=sparse_s, timing=timing)


def compute_jaccard_distance_ivf(
        features: torch.Tensor, k1: int = 20, k2: int = 6,
        sparse_s: Optional[int] = None, nlist: int = 256, nprobe: int = 32,
        generator: Optional[torch.Generator] = None,
        timing: Optional[dict] = None) -> torch.Tensor:
    """Jaccard with an IVF approximate initial ranking (ref
    faiss_utils.py:158-181 GpuIndexIVFFlat): the O(N^2 D) self-kNN becomes
    about O(N * nprobe/nlist * N D) through `ops/ivf.py`; the re-ranking
    downstream is unchanged, and the ranking's recall is the IVF recall
    (exact when nprobe covers every list). `generator` draws k-means'
    initial rows (`ops.kmeans.init_indices`). `timing` gets the seconds of
    kmeans and buckets (the index), topk, then `_jaccard_from_rank`'s
    steps."""
    from .ivf import build_ivf, ivf_topk

    feats = features.to(torch.float32)
    feats = feats / torch.clamp(torch.linalg.norm(feats, dim=1, keepdim=True),
                                min=1e-12)
    index = build_ivf(feats, nlist=min(nlist, feats.shape[0]),
                      generator=generator, timing=timing)
    stages = StageTimer(timing, feats.device)
    _, initial_rank = ivf_topk(index, feats, k=k1,
                               nprobe=min(nprobe, nlist))
    # a -1 pad (a probed set smaller than k1) becomes self, so that the
    # masks downstream stay valid
    self_idx = torch.arange(feats.shape[0], device=feats.device)[:, None]
    initial_rank = torch.where(initial_rank >= 0, initial_rank, self_idx)
    stages.mark("topk")
    return _jaccard_from_rank(feats, initial_rank, k1=k1, k2=k2,
                              sparse_s=sparse_s, timing=timing)


def compute_jaccard_distance_sharded(
        mesh, features: torch.Tensor, k1: int = 20, k2: int = 6,
        sparse_s: Optional[int] = None,
        timing: Optional[dict] = None) -> torch.Tensor:
    """Row-sharded Jaccard over the ranks of `mesh`
    (`reid_tpu/ops/rerank.py:190-311`): every (N, N) intermediate of this
    rank's rows lives as an (N/p, N) block; every rank holds the
    features, the (N, k1) ranking and the half-size reciprocal masks.

    Arbitrary N: the rows are zero-padded to a multiple of p; a padded
    row is in no real row's ranking or reciprocal set and its V and J
    rows are zero, and the result is sliced back to (N, N). The columns
    are never padded, so every column reduction (the softmax, the
    min-sum, the L1 over V) has the same length at every world size,
    and world p is bit-equal to world 1 (and world 1 to
    `compute_jaccard_distance` where the ranking has no ties). Each rank
    ranks its rows by the squared distance (K6 on the (N/p, N) block)
    with itself first, as JAX's sharded path ranks by similarity with
    itself first; the rankings are all-gathered (N x k1 indices). It
    builds its rows of the k-reciprocal and expansion masks and of V
    (`_v_rows`, the dense path's body on a row block); one all_gather of V gives every rank the whole V, the k2 query
    expansion runs on it, and each rank takes the min-sum of its rows
    against all of V: K7's (N/p, N) x (N, N) slab, or the top-S sparse
    gather under the per-shard exactness guard (the dense L1 where a
    local row has more than S nonzeros). The (N/p, N) blocks of J are
    all-gathered, so every rank returns the whole matrix. Without a
    process group (`mesh` None or groupless) it is the same program
    without collectives; a one-rank group runs them as identities.
    `timing` gets
    the seconds of topk, masks, overlap, v, gather, expansion, minsum
    and gather_j."""
    from ..parallel.mesh import all_gather_rows

    n = features.shape[0]
    p = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    dev = features.device
    stages = StageTimer(timing, dev)
    feats = features.to(torch.float32)
    feats = feats / torch.clamp(torch.linalg.norm(feats, dim=1, keepdim=True),
                                min=1e-12)
    per = -(-n // p)
    r0 = rank * per
    m = max(min(per, n - r0), 0)             # this rank's real rows

    def padded(t):
        """This rank's (m, ...) rows padded with zero rows to `per`."""
        if m == per:
            return t
        return torch.cat([t, t.new_zeros((per - m, *t.shape[1:]))])

    # this rank's ranking, itself first; the rankings all-gathered
    _, rank_rows = topk_neighbors(feats[r0:r0 + m], feats, k1,
                                  self_first=r0)
    initial_rank = all_gather_rows(padded(rank_rows).contiguous(),
                                   mesh)[:n]                  # (N, k1)
    stages.mark("topk")
    v_rows = padded(_v_rows(feats, initial_rank, k1, r0, m, stages))
    v = all_gather_rows(v_rows, mesh)[:n]                 # (N, N)
    del v_rows
    stages.mark("gather")
    v = _query_expansion(v, initial_rank, k2)
    stages.mark("expansion")
    jac = padded(_minsum_jaccard(v[r0:r0 + m], v, sparse_s) if m
                 else v.new_zeros((0, n)))
    del v
    stages.mark("minsum")
    jac = all_gather_rows(jac, mesh)[:n]
    stages.mark("gather_j")
    return jac


def jaccard_distance(features: torch.Tensor, k1: int = 20, k2: int = 6,
                     sparse_s: Optional[int] = None,
                     search_option: Optional[str] = None,
                     timing: Optional[dict] = None,
                     mesh=None) -> torch.Tensor:
    """The dispatcher `eval/inference.py` calls. `search_option` applies
    the gallery-size policy (ops/policy.py): "auto" picks dense or top-S
    sparse by N; "dense" and "sparse" force one. None keeps the legacy
    behaviour (dense unless `sparse_s` is given); "ivf" takes the IVF
    ranking with the plan's nlist and nprobe. `timing` gets the seconds of
    each step (topk, then `_jaccard_from_rank`'s). With a `mesh` of more
    than one rank (as in the JAX package; a one-rank group runs the
    single-device path), the row-sharded path (`compute_jaccard_distance_sharded`)
    runs instead, the policy's ceilings scaled by the ranks; it has no IVF
    variant, so "ivf" there degrades to the sharded top-S sparse min-sum
    (each rank already holds N/p rows), as in the JAX package."""
    multi = mesh is not None and mesh.size > 1
    if search_option is not None:
        from .policy import choose_search
        plan = choose_search(int(features.shape[0]), search_option,
                             sparse_s or 0,
                             n_devices=mesh.size if multi else 1)
        if plan.strategy == "ivf" and not multi:
            return compute_jaccard_distance_ivf(
                features, k1=k1, k2=k2, sparse_s=plan.sparse_s,
                nlist=plan.nlist, nprobe=plan.nprobe, timing=timing)
        sparse_s = plan.sparse_s
    if multi:
        return compute_jaccard_distance_sharded(mesh, features, k1=k1, k2=k2,
                                                sparse_s=sparse_s,
                                                timing=timing)
    return compute_jaccard_distance(features, k1=k1, k2=k2,
                                    sparse_s=sparse_s, timing=timing)

