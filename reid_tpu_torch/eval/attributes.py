"""The Market-1501 attribute prior (ref
`reid/tricks/additional_market_attributes.py`).

An own copy of `reid_tpu/eval/attributes.py` (NumPy and SciPy, no JAX), so
that the port imports nothing of the JAX package. Loads
`market_attribute.mat` (27 binary attributes and the age one-hot) and
builds a normalized attribute Euclidean distance matrix over the
[gallery ; query] identity sequence, which inference adds to the Jaccard
distances (ref image_reid_inference.py:276-289).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_attributes(mat_path: str, split: str = "test"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (identity_ids (N,), attribute matrix (N, A) float32): age
    expanded to a one-hot over its 4 values, every other attribute moved
    from {1, 2} to {0, 1} (ref get_attributes :11-26)."""
    from scipy.io import loadmat

    mat = loadmat(mat_path)
    root = mat["market_attribute"][0][0]
    table = root[split][0][0] if root.dtype.names else root[
        {"train": 1, "test": 0}[split]][0][0]
    names = table.dtype.names
    # .mat cells arrive as 0-d or 1-element arrays
    ids = np.asarray([int(np.asarray(v).reshape(-1)[0])
                      for v in table["image_index"][0]])
    cols = []
    for name in names:
        if name == "image_index":
            continue
        vals = table[name][0].astype(np.float32)
        if name == "age":
            onehot = np.zeros((len(vals), 4), np.float32)
            onehot[np.arange(len(vals)), vals.astype(int) - 1] = 1.0
            cols.append(onehot)
        else:
            cols.append((vals - 1.0)[:, None])
    return ids, np.concatenate(cols, axis=1)


def get_attribute_dist(ids: np.ndarray, attrs: np.ndarray,
                       sample_pids: np.ndarray,
                       scale: float = 1.0) -> np.ndarray:
    """Per-sample attribute distance matrix (ref :29-38): each sample's
    pid maps to its attribute vector (zeros for an unknown pid, e.g. a
    distractor), then pairwise Euclidean distances scaled to [0, scale]."""
    lut = {int(pid): attrs[i] for i, pid in enumerate(ids)}
    a = np.stack([lut.get(int(p), np.zeros(attrs.shape[1], np.float32))
                  for p in sample_pids])
    d = np.linalg.norm(a[:, None, :] - a[None, :, :], axis=-1)
    mx = d.max()
    return (d / mx * scale).astype(np.float32) if mx > 0 \
        else d.astype(np.float32)
