"""k-means (Lloyd) with a fixed iteration count.

Counterpart of `reid_tpu/ops/kmeans.py` (the faiss KMeans role, ref
`gan/kmeans_.py:37-44`). Plain PyTorch on the caller's device, as the JAX
package leaves it to XLA (`use_pallas=False`): the assignment is the argmin
of one squared-distance product (`distance.sqeuclidean_plain`, the JAX
package's `_jnp_sqeuclidean`), the centre update a one-hot product, which
sums in a fixed order on the card (no atomics), so the card and the CPU
bucket alike.

The initial centres are rows drawn without replacement by `init_indices`
from an explicit `torch.Generator`. `jax.random.choice` cannot be
reproduced, so a comparison with the JAX package replaces `init_indices`
with one that returns JAX's rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .distance import sqeuclidean_plain


def init_indices(n: int, k: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """k distinct row indices of n, drawn on the host from `generator`
    (a CPU generator seeded 0 when None), so that every device starts from
    the same rows."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randperm(n, generator=generator)[:k]


def kmeans(x: torch.Tensor, k: int, iters: int = 25,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (labels (N,) int64, centers (k, D) f32) after `iters` Lloyd
    steps from the rows `init_indices(N, k, generator)`.
    An empty cluster keeps its centre."""
    n = x.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k = {k} clusters of {n} rows")
    xf = x.to(torch.float32)
    centers = xf[init_indices(n, k, generator).to(x.device)]
    for _ in range(iters):
        labels = torch.argmin(sqeuclidean_plain(xf, centers), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)
        counts = onehot.sum(0)
        sums = onehot.T @ xf
        centers = torch.where((counts > 0)[:, None],
                              sums / torch.clamp(counts, min=1.0)[:, None],
                              centers)
    labels = torch.argmin(sqeuclidean_plain(xf, centers), dim=1)
    return labels, centers
