"""IVF search: the port's k-means, `build_ivf`, `ivf_topk` and
`compute_jaccard_distance_ivf` against the JAX package's on the same numpy
inputs. `jax.random.choice` cannot be reproduced in PyTorch, so the port
is handed JAX's initial k-means rows. Labels, bucket ids and rankings are
equal; centres, distances and Jaccard values agree within 1e-5 (f32
products summed in each framework's own order), distances of rows that
are not unit-norm within 1e-5 of their squared norms."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.ops import rerank as jrr
from reid_tpu_torch.ops import ivf as tivf
from reid_tpu_torch.ops import kmeans as tkm
from reid_tpu_torch.ops import rerank as trr
from reid_tpu_torch.ops.distance import topk_neighbors
from test_torch_train_data import two_torch_threads  # noqa: F401

# `reid_tpu.ops` exports functions under these modules' names
jivf = importlib.import_module("reid_tpu.ops.ivf")
jkm = importlib.import_module("reid_tpu.ops.kmeans")


def clustered(n_clusters=8, per=24, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 5
    return (np.repeat(centers, per, 0)
            + 0.3 * rng.normal(size=(n_clusters * per, d))).astype(np.float32)


def skewed(seed=0):
    """tests/test_ops.py's gallery: one tight blob of 800 rows and 200
    far-away rows, which k-means lumps so that the index must re-split."""
    rng = np.random.default_rng(seed)
    blob = rng.normal(size=(800, 12)) * 0.05
    far = rng.normal(size=(200, 12)) * 0.05 + rng.integers(
        -50, 50, (200, 1)) * np.eye(1, 12)
    return np.concatenate([blob, far]).astype(np.float32)


def jax_init(n, k, key=0):
    """The rows `reid_tpu.ops.kmeans` starts from under PRNGKey(key)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(key), n, (k,),
                                        replace=False))


@pytest.fixture
def jax_rows(monkeypatch):
    """The port's k-means starts from JAX's rows for PRNGKey(0)."""
    monkeypatch.setattr(tkm, "init_indices",
                        lambda n, k, generator=None: torch.tensor(
                            jax_init(n, k)))


def test_kmeans_matches_jax(monkeypatch):
    x = clustered()
    # a CPU generator seeded 0 is the default draw
    a = tkm.kmeans(torch.from_numpy(x), 8, iters=2)[0]
    b = tkm.kmeans(torch.from_numpy(x), 8, iters=2,
                   generator=torch.Generator().manual_seed(0))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    lj, cj = jkm.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), k=8, iters=10)
    monkeypatch.setattr(tkm, "init_indices",
                        lambda n, k, generator=None: torch.tensor(
                            jax_init(n, k)))
    lt, ct = tkm.kmeans(torch.from_numpy(x), 8, iters=10)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)


def build_both(g, nlist, **kw):
    """Both packages' index of `g`, and the build warnings of each."""
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ji = jivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(g),
                            nlist=nlist, **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ti = tivf.build_ivf(torch.from_numpy(g), nlist=nlist, **kw)
    names = [[str(w.message).split(":")[0] for w in ws
              if "build_ivf" in str(w.message)] for ws in (wj, wt)]
    return ji, ti, names


def unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["clustered", "skewed"])
def test_build_ivf_and_topk_match_jax(case, jax_rows):
    # unit rows, as the IVF Jaccard feeds them; the skewed gallery keeps
    # its raw rows, whose far blob the re-split needs
    g = unit(clustered()) if case == "clustered" else skewed()
    nlist = 8
    ji, ti, _ = build_both(g, nlist)
    np.testing.assert_array_equal(ti.bucket_ids.numpy(),
                                  np.asarray(ji.bucket_ids))
    np.testing.assert_allclose(ti.centroids.numpy(),
                               np.asarray(ji.centroids), atol=1e-5)
    if case == "skewed":    # the re-split ran and kept the lists narrow
        assert ti.buckets.shape[0] > nlist
        assert ti.buckets.shape[1] <= 4.0 * len(g) / nlist + 1
        # where balance cannot be reached, both warn alike
        ji2, ti2, names = build_both(g, nlist, max_imbalance=0.25)
        assert names[0] == names[1] == ["build_ivf"]
        np.testing.assert_array_equal(ti2.bucket_ids.numpy(),
                                      np.asarray(ji2.bucket_ids))
    q = np.random.default_rng(1).normal(size=(17, g.shape[1])).astype(
        np.float32)
    q[:5] = g[::len(g) // 5][:5] + 0.01
    if case == "clustered":
        q = unit(q)
    # a distance is |q|^2 + |g|^2 - 2 q.g in f32, so its rounding scales
    # with the squared norms: 1e-5 for unit rows, 1e-5 of the largest sum
    # of squared norms (about 800) for the skewed gallery's far rows
    scale = max(1.0, float((q * q).sum(1).max() + (g * g).sum(1).max()))
    for nprobe in (2, len(ti.centroids)):
        dj, ij = jivf.ivf_topk(ji, jnp.asarray(q), k=5, nprobe=nprobe)
        dt, it = tivf.ivf_topk(ti, torch.from_numpy(q), k=5, nprobe=nprobe,
                               block_q=8)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                                   atol=1e-5 * scale)
    # probing every list is exact: brute force's ranking
    _, ib = topk_neighbors(torch.from_numpy(q), torch.from_numpy(g), k=5)
    np.testing.assert_array_equal(it.numpy(), ib.numpy())


def test_ivf_topk_pads_past_the_candidates(monkeypatch):
    g = clustered(n_clusters=4, per=3, d=8)
    # one initial row in each cluster
    monkeypatch.setattr(tkm, "init_indices", lambda n, k, generator=None:
                        torch.tensor([0, 3, 6, 9]))
    ti = tivf.build_ivf(torch.from_numpy(g), nlist=4)
    d, i = tivf.ivf_topk(ti, torch.from_numpy(g[:2]), k=8, nprobe=1)
    assert (i[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()
    assert (i[:, :3] >= 0).all()


@pytest.mark.parametrize("nprobe", [4, 8])
def test_jaccard_ivf_matches_jax(nprobe, jax_rows):
    f = clustered(per=16)
    want = np.asarray(jrr.compute_jaccard_distance_ivf(
        jnp.asarray(f), k1=10, k2=3, nlist=8, nprobe=nprobe))
    got = trr.compute_jaccard_distance_ivf(torch.from_numpy(f), k1=10, k2=3,
                                           nlist=8, nprobe=nprobe)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the dispatcher's "ivf" plan runs it instead of refusing
    plan = trr.jaccard_distance(torch.from_numpy(f), k1=10, k2=3,
                                search_option="ivf")
    assert plan.shape == (len(f), len(f)) and torch.isfinite(plan).all()
