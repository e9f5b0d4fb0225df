"""The port's k-reciprocal re-ranking against `reid_tpu.ops.rerank` on the
CPU (both run their plain distance paths), on the cases of
tests/test_ops.py.

Tolerances: Jaccard matrices within atol = 1e-5 (the softmax, the query
expansion sum and the L1 sums round in another order; measured up to
2.4e-7); masks and the search policy identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.ops.policy as jp
import reid_tpu.ops.rerank as jr
from reid_tpu_torch.ops import policy as tp
from reid_tpu_torch.ops import rerank as tr
from test_torch_train_data import two_torch_threads  # noqa: F401


def clustered(rng, n_centers, per, dim, spread, scale=3.0):
    centers = rng.normal(size=(n_centers, dim)) * scale
    return (np.repeat(centers, per, 0)
            + spread * rng.normal(size=(n_centers * per, dim))
            ).astype(np.float32)


def both(fn_j, fn_t, feats, **kw):
    want = np.asarray(fn_j(jnp.asarray(feats), **kw))
    got = fn_t(torch.from_numpy(feats), **kw).numpy()
    return got, want


CASES = {
    # (features, k1, k2, sparse_s)
    "dense": (lambda r: clustered(r, 5, 10, 12, 0.3), 8, 3, None),
    "dense_default_k": (lambda r: r.normal(size=(90, 40)).astype(
        np.float32), 20, 6, None),
    "sparse": (lambda r: clustered(r, 8, 16, 32, 0.1, 1.0), 10, 3, 64),
    "sparse_ragged": (lambda r: clustered(r, 8, 16, 32, 0.1, 1.0)[:100], 10,
                      3, 64),
    # one tight blob: the expansion support is ~N wide, far beyond S = 8,
    # so the sparse request falls back to the dense min-sum
    "sparse_overflow": (lambda r: (r.normal(size=(64, 16)) * 0.01).astype(
        np.float32), 20, 6, 8),
    "k2_is_1": (lambda r: clustered(r, 4, 12, 8, 0.5), 6, 1, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_jaccard_distance_matches_jax(case):
    make, k1, k2, s = CASES[case]
    feats = make(np.random.default_rng(0))
    got, want = both(jr.compute_jaccard_distance, tr.compute_jaccard_distance,
                     feats, k1=k1, k2=k2, sparse_s=s)
    assert got.shape == want.shape == (len(feats), len(feats))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sparse_overflow_equals_dense():
    feats = CASES["sparse_overflow"][0](np.random.default_rng(0))
    f = torch.from_numpy(feats)
    dense = tr.compute_jaccard_distance(f, k1=20, k2=6)
    sparse = tr.compute_jaccard_distance(f, k1=20, k2=6, sparse_s=8)
    assert torch.equal(dense, sparse)


def test_minsum_topk_rows_matches_jax(monkeypatch):
    monkeypatch.setattr(tr, "_MINSUM_ROWS", 16)
    rng = np.random.default_rng(1)
    v = rng.random((70, 90)).astype(np.float32)
    v[v < 0.8] = 0.0
    v /= v.sum(1, keepdims=True)
    want = np.asarray(jr._minsum_topk_rows(jnp.asarray(v[:50]),
                                           jnp.asarray(v), 32, block_i=16))
    got = tr._minsum_topk_rows(torch.from_numpy(v[:50]), torch.from_numpy(v),
                               32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_topk_mask_matches_jax():
    idx = np.random.default_rng(2).integers(0, 30, (12, 5))
    want = np.asarray(jr._topk_mask(jnp.asarray(idx), 30))
    got = tr._topk_mask(torch.from_numpy(idx), 30).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("option", ["auto", "dense", "sparse", "ivf"])
@pytest.mark.parametrize("n", [10, 15_000, 15_001, 23_100, 150_000])
@pytest.mark.parametrize("sparse_s", [0, 256])
def test_choose_search_equals_jax(option, n, sparse_s):
    for n_devices in (1, 4):
        assert tp.choose_search(n, option, sparse_s, n_devices) == \
            tp.SearchPlan(*jp.choose_search(n, option, sparse_s, n_devices)
                          .__dict__.values())
    with pytest.raises(ValueError):
        tp.choose_search(n, "bogus")


@pytest.mark.parametrize("option", [None, "auto", "dense", "sparse"])
def test_jaccard_distance_dispatcher_matches_jax(option):
    feats = clustered(np.random.default_rng(3), 8, 16, 32, 0.1, 1.0)
    got, want = both(jr.jaccard_distance, tr.jaccard_distance, feats, k1=10,
                     k2=3, search_option=option)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_jaccard_distance_ivf_matches_jax(monkeypatch):
    """search_option="ivf" is not refused: the dispatcher takes the IVF
    ranking with `choose_search`'s nlist and nprobe, as the JAX package's
    does (the port's k-means starting from JAX's rows, which
    `jax.random.choice` draws and PyTorch cannot reproduce)."""
    import jax

    from reid_tpu_torch.ops import kmeans as tkm
    monkeypatch.setattr(tkm, "init_indices", lambda n, k, generator=None:
                        torch.tensor(np.asarray(jax.random.choice(
                            jax.random.PRNGKey(0), n, (k,),
                            replace=False))))
    feats = clustered(np.random.default_rng(5), 6, 10, 8, 0.3)
    got, want = both(jr.jaccard_distance, tr.jaccard_distance, feats, k1=10,
                     k2=3, search_option="ivf")
    np.testing.assert_allclose(got, want, atol=1e-5)
