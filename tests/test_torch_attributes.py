"""The Market attribute prior: the port's own copy of
`reid_tpu/eval/attributes.py` against the JAX package's on `.mat` files
written with `scipy.io.savemat` (as tests/test_eval.py writes one, the
layout of the published file: a struct with a "test" and a "train" table):
ids, attribute matrix and distance matrix equal, bit for bit, with pids
the table lacks (distractors)."""

import numpy as np
import pytest
from scipy import io as scipy_io

from reid_tpu.eval import attributes as jattr
from reid_tpu_torch.eval import attributes as tattr


def write_mat(path, n_ids, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(1500, n_ids, replace=False)) + 1
    fields = {"image_index": np.asarray([[f"{i:04d}" for i in ids]],
                                        dtype=object),
              "age": rng.integers(1, 5, (1, n_ids)).astype(float)}
    for name in ("backpack", "bag", "gender", "hat", "upred"):
        fields[name] = rng.integers(1, 3, (1, n_ids)).astype(float)
    scipy_io.savemat(path, {"market_attribute": {"test": fields,
                                                 "train": fields}})
    return ids


@pytest.mark.parametrize("seed", [0, 1])
def test_attributes_match_jax(tmp_path, seed):
    path = str(tmp_path / "market_attribute.mat")
    ids = write_mat(path, 40, seed=seed)
    for split in ("test", "train"):
        ij, aj = jattr.get_attributes(path, split)
        it, at = tattr.get_attributes(path, split)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(at, aj)
        assert at.shape == (40, 4 + 5) and at.dtype == np.float32
    np.testing.assert_array_equal(it, ids)
    pids = np.concatenate([ids[::3], [0, -1, 9999], ids[1::5]])
    for scale in (1.0, 0.5):
        want = jattr.get_attribute_dist(ij, aj, pids, scale=scale)
        got = tattr.get_attribute_dist(it, at, pids, scale=scale)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32 and got.max() == np.float32(scale)
    # no known pid: all zeros, no division
    zero = tattr.get_attribute_dist(it, at, np.asarray([0, -1]))
    np.testing.assert_array_equal(zero, np.zeros((2, 2), np.float32))
