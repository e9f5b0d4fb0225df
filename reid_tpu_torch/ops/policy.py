"""Gallery-size search policy — the faiss `search_option` role.

An own copy of `reid_tpu/ops/policy.py` (pure Python, unchanged below this
paragraph; a test holds the two equal on every option), so that the port
imports nothing of the JAX package. Every measurement in these notes, and
the crossover points they set, was taken on a TPU v5e by the JAX package;
none has been taken on the card. The port's `jaccard_distance` runs the
"ivf" plan through its own `ops/ivf.py`, which `option="ivf"` selects and
"auto" never does.

The reference picks its retrieval engine by an explicit CLI option
(ref `reid/faiss_utils.py:121-181`: 0 GpuIndexFlatL2 brute force,
1 IndexShards over GPUs, 2 CPU->GPU cloner, 3 GpuIndexIVFFlat for big
galleries). Here the same decision is made automatically from the gallery
size, with the measured v5e crossover points:

  * n <= DENSE_MAX     dense Jaccard: the full (N, N) min-sum identity.
                       The N^2 f32 sim matrix is the limit — 23k rows was
                       7.5 s / ~2.1 GB.
  * n  > DENSE_MAX     top-S sparse min-sum (S=512): exact when the
                       k-reciprocal support fits S (runtime-guarded
                       fallback), 2.1-2.4x at N=23k. Min-sum HBM traffic
                       drops to O(N^2*S/K); the V encoding itself stays a
                       dense (N, N) matrix, which (with the J output) is
                       what caps the single-chip full re-rank.

The initial self-kNN stays BRUTE FORCE (blocked MXU matmul + top_k) at
every gallery size: measured on the v5e (2026-08-18, clustered unit-norm
galleries, D=1280, 4096-query blocks) brute force takes 0.056 s/4k at
N=50k and 0.068 s/4k at N=100k while ivf_topk at nprobe=8 takes
0.35-0.43 s/4k — the bucket gather is lane-hostile on TPU and loses to
the MXU matmul by 5-8x, and the padded (C, B, D) bucket tensor itself
OOMs HBM near N=200k under cluster skew. IVF (`ops/ivf.py`) therefore
remains EXPLICIT OPT-IN ONLY (`option="ivf"`, the faiss search_option 3
API role) and is never auto-selected.

The multi-chip sharded path keeps dense rows (each chip holds N/devices
rows) so its dense ceiling scales with the mesh; sparse kicks in at
DENSE_MAX * n_devices.

Measured numbers that set the defaults are recorded in ROUND_NOTES.md
("Large-gallery scaling", round 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

DENSE_MAX = 15_000      # beyond this the top-S sparse path wins (measured)
SPARSE_MAX = 23_000     # measured single-chip ceiling of the FULL (N, N)
                        # re-rank matrix (v5e 16 GB: 23k ok, 30k OOMs even
                        # in a fresh process); the sharded path scales it
                        # ~linearly with mesh size. Beyond it the product
                        # operation is kNN retrieval (brute force —
                        # measured faster than IVF at every N). Informative
                        # only: choose_search still returns "sparse" and
                        # the caller sizes the output it can hold.


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    strategy: str              # "dense" | "sparse" | "ivf"
    sparse_s: Optional[int]    # top-S width (None = dense min-sum)
    nlist: int = 0             # IVF lists (0 = no IVF)
    nprobe: int = 0


def choose_search(n: int, option: str = "auto", sparse_s: int = 0,
                  n_devices: int = 1) -> SearchPlan:
    """Resolve a search plan for an n-row gallery.

    `option`: "auto" (size-based, the search_option role), or an explicit
    "dense" / "sparse" / "ivf" override. `sparse_s` > 0 forces that top-S
    width on any strategy (the RetrievalConfig.rerank_sparse_s escape
    hatch). `n_devices` scales the dense/sparse ceilings for the sharded
    path (rows are split across chips)."""
    if option == "auto":
        # measured v5e policy: dense -> sparse by size; never IVF (the
        # brute-force MXU kNN beats ivf_topk at every N — module docstring)
        if n <= DENSE_MAX * max(n_devices, 1):
            option = "dense"
        else:
            option = "sparse"
    if option == "dense":
        return SearchPlan("dense", sparse_s or None)
    if option == "sparse":
        return SearchPlan("sparse", sparse_s or 512)
    if option == "ivf":
        # nlist ~ 4*sqrt(n) (faiss guidance), nprobe = nlist/8: ~8x less
        # candidate traffic at >=0.99 recall@k1 on clustered galleries
        # (measured, ROUND_NOTES r4)
        nlist = max(64, min(4096, 1 << int(math.log2(
            4.0 * math.sqrt(max(n, 1)) + 1))))
        return SearchPlan("ivf", sparse_s or 512, nlist=nlist,
                          nprobe=max(8, nlist // 8))
    raise ValueError(f"unknown search option: {option!r} "
                     "(auto|dense|sparse|ivf)")
