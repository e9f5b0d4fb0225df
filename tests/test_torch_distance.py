"""The port's distance ops against `reid_tpu.ops.distance` on the CPU, where
the port's wrappers run their plain versions and the JAX functions their
jnp paths (the Pallas kernels are TPU-only).

Tolerances:
  * sqeuclidean, cosine: rtol = atol = 1e-5 (the norms and the matmul sum
    in another order);
  * l1: rtol = atol = 1e-5 (the |x - y| sums run in another order);
  * topk_neighbors: indices identical, ties included (integer-valued rows
    make the squared distances exact and tie in large groups; both sides
    order ties lowest index first), distances within 1e-5, with query
    blocks that split the rows and with one block that holds them all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.ops.distance as jd
from reid_tpu_torch.ops import distance as td
from reid_tpu_torch.ops import launch_counts, reset_launch_counts
from test_torch_train_data import two_torch_threads  # noqa: F401

SHAPES = [(33, 21, 17), (1, 130, 129), (129, 7, 300)]


def pair(rng, m, n, d):
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_sqeuclidean_plain_matches_jax(m, n, d):
    x, y = pair(np.random.default_rng(m), m, n, d)
    want = np.asarray(jd.pairwise_sqeuclidean(jnp.asarray(x), jnp.asarray(y)))
    got = td.sqeuclidean_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        td.pairwise_sqeuclidean(torch.from_numpy(x), torch.from_numpy(y))
        .numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_l1_plain_matches_jax(m, n, d, monkeypatch):
    x, y = pair(np.random.default_rng(n), m, n, d)
    want = np.asarray(jd.pairwise_l1(jnp.asarray(x), jnp.asarray(y)))
    got = td.l1_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # blocks of D as well as of rows (the budget a slab at D = 23,100 hits)
    monkeypatch.setattr(td, "_L1_BUDGET", 4 * n * 10)
    monkeypatch.setattr(td, "_L1_ROWS", 4)
    got = td.l1_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cosine_matches_jax():
    x, y = pair(np.random.default_rng(5), 40, 50, 24)
    want = np.asarray(jd.pairwise_cosine(jnp.asarray(x), jnp.asarray(y)))
    got = td.pairwise_cosine(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_q", [16, 1024])
def test_topk_neighbors_matches_jax(block_q):
    rng = np.random.default_rng(2)
    g = rng.integers(-2, 3, (97, 6)).astype(np.float32)
    g[40:60] = g[0]                       # exact duplicates: tied rows
    q = np.concatenate([g[:20], rng.integers(-2, 3, (19, 6))]).astype(
        np.float32)
    dj, ij = jd.topk_neighbors(jnp.asarray(q), jnp.asarray(g), k=25,
                               block_q=16)
    dt, it = td.topk_neighbors(torch.from_numpy(q), torch.from_numpy(g),
                               k=25, block_q=block_q)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    assert np.all(np.diff(dt.numpy(), axis=1) >= 0)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    x, y = pair(np.random.default_rng(0), 5, 6, 7)
    reset_launch_counts()
    a = td.sqeuclidean(torch.from_numpy(x), torch.from_numpy(y))
    b = td.l1(torch.from_numpy(x), torch.from_numpy(y))
    assert a.shape == b.shape == (5, 6)
    assert launch_counts() == {}
