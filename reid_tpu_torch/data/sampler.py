"""PK identity sampling as an epoch-level index generator.

An own copy of `reid_tpu/data/sampler.py` (NumPy on the host, unchanged;
a test holds the two bit-equal), so that the port imports nothing of the
JAX package.

Ref `reid/data_prepare.py:143-203` (RandomIdentitySampler_): for each pid,
shuffle its indices, chop into groups of K (oversampling with replacement if
fewer than K); then repeatedly draw P = batch/K pids from the available pool,
emitting one K-group per drawn pid, until fewer than P pids remain. Each
batch therefore holds P distinct pids with K instances each.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence

import numpy as np


def pk_epoch_indices(
    labels: Sequence[int],
    batch_size: int,
    num_instances: int,
    rng: np.random.Generator,
) -> np.ndarray:
    k = num_instances
    p = batch_size // k
    index_dic = defaultdict(list)
    for idx, pid in enumerate(labels):
        index_dic[int(pid)].append(idx)
    pids = list(index_dic)

    batch_groups = {}
    for pid in pids:
        idxs = np.asarray(index_dic[pid])
        if len(idxs) < k:
            idxs = rng.choice(idxs, size=k, replace=True)
        else:
            idxs = rng.permutation(idxs)
        n_groups = len(idxs) // k
        batch_groups[pid] = [idxs[i * k:(i + 1) * k].tolist()
                             for i in range(n_groups)]

    avail = [pid for pid in pids if batch_groups[pid]]
    out: List[int] = []
    while len(avail) >= p:
        chosen = rng.choice(len(avail), size=p, replace=False)
        # iterate on a copy: removal during iteration
        for pid in [avail[c] for c in chosen]:
            out.extend(batch_groups[pid].pop(0))
            if not batch_groups[pid]:
                avail.remove(pid)
    return np.asarray(out, np.int64)
