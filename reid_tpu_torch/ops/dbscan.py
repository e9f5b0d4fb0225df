"""DBSCAN over a precomputed distance matrix.

An own copy of `reid_tpu/ops/dbscan.py` (NumPy on the host, unchanged), so
that the port imports nothing of the JAX package.

Replaces sklearn/cuML DBSCAN (ref `reid/image_reid_inference.py:290-301`,
`image_reid_train.py:388-389`). The distance matrix is produced on-device
(Jaccard re-rank); the clustering itself is a cheap host-side BFS over the
eps-neighborhood graph — O(N^2) bitwise ops on a matrix we already paid for.

Semantics match sklearn's DBSCAN(metric="precomputed"): core point = at least
`min_samples` neighbors within eps (count includes the point itself); clusters
grow from core points; border points join the first cluster that reaches
them; everything else is noise (-1).
"""

from __future__ import annotations

import numpy as np


def dbscan_precomputed(
    dist: np.ndarray, eps: float, min_samples: int
) -> np.ndarray:
    """Returns labels (N,) int32; -1 = noise."""
    dist = np.asarray(dist)
    n = dist.shape[0]
    neighbors = dist <= eps                      # (N, N) bool, includes self
    n_neighbors = neighbors.sum(axis=1)
    core = n_neighbors >= min_samples

    labels = np.full(n, -1, np.int32)
    cluster = 0
    visited = np.zeros(n, bool)
    for i in range(n):
        if visited[i] or not core[i]:
            continue
        # BFS over core points, expanding through eps-neighborhoods.
        frontier = np.zeros(n, bool)
        frontier[i] = True
        members = np.zeros(n, bool)
        while frontier.any():
            members |= frontier
            # only core points expand the cluster
            expand = frontier & core
            reached = neighbors[expand].any(axis=0) if expand.any() else np.zeros(n, bool)
            frontier = reached & ~members
        labels[members] = cluster
        visited |= members
        cluster += 1
    return labels
