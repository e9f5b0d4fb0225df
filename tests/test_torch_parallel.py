"""The port's distributed layer (`reid_tpu_torch/parallel/`) against the
JAX package's mesh forms, on the CPU.

The port runs gloo at world size 2 in two subprocess ranks
(`torch_ranks.launch`, one launch for the whole file, 120 s at most) and
at world size 1 in this process; JAX runs on its 8-virtual-device CPU
mesh (`make_mesh(2)`, `make_mesh_2d(1, 2)`), here. Inputs are drawn from
seeded numpy.

  * `sharded_gallery_topk`: distances within 1e-5 relative of JAX's and
    indices equal (data without ties), and the same neighbours as the
    port's dense top-k;
  * `compute_jaccard_distance_sharded` with N = 63 (padded to 64) and
    with `sparse_s` (exact, and overflowing into the dense fallback):
    within 1e-6 of JAX's sharded Jaccard; world 2 bit-equal to world 1,
    and world 1 bit-equal to the dense single-device Jaccard, there and
    with N = 64, k2 = 1; "ivf" on a mesh degrades to the sharded sparse
    path;
  * `place_batch` / `shard_batch` / `replicate`, and the
    `shard_params_tp` placements against JAX's rules
    (tests/test_tp_sharding.py) with a column-parallel matmul;
  * train-mode BatchNorm and BatchRenorm under global statistics, world 2
    against world 1 on the concatenated batch: outputs, running
    statistics and input gradients within 1e-6 relative;
  * `make_stream_tracker(mesh=)` at world 2 against the one-process
    stream tracker: ids, boxes and valid flags equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_train_data import two_torch_threads  # noqa: F401
from torch_ranks import launch, norm_step, run_streams

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

TP_SHAPES = {"classifier": (512, 752), "small": (8, 8),
             "centers": (751, 512), "odd": (751, 3), "scalar": (7,)}


def clustered(n, d=12, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d)) * 3
    f = np.concatenate([c + 0.3 * rng.normal(size=(16, d)) for c in centers])
    return f[:n].astype(np.float32)


def stream_scenes():
    from _scenes import build_mot_scene
    seqs = [build_mot_scene(t_total=16, n_t=4, max_dets=8, h=120, w=160,
                            seed=s)[:4] for s in range(4)]
    return [np.stack([q[i] for q in seqs]) for i in range(4)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    feats = clustered(63)
    return {
        "topk": (rng.normal(size=(5, 16)).astype(np.float32),
                 rng.normal(size=(64, 16)).astype(np.float32), 4),
        "jaccard": [(feats, 8, 3, None), (feats, 8, 3, 48),
                    (feats, 8, 3, 1), (clustered(64, seed=1), 6, 1, None)],
        "batch": {"images": rng.normal(size=(8, 4, 2, 3)).astype(np.float32),
                  "labels": np.arange(8, dtype=np.int64),
                  "flip_u": rng.uniform(size=(8,)).astype(np.float32)},
        "tp": TP_SHAPES,
        "norms": (rng.normal(size=(8, 5, 3, 6)).astype(np.float32) * 2 + 1,
                  rng.normal(size=(8, 5, 3, 6)).astype(np.float32)),
        "streams": (stream_scenes(), "strongsort", 8, 16, 8, (32, 16)),
    }


@pytest.fixture(scope="module")
def world2(inputs):
    job = dict(inputs, programs=["topk", "jaccard", "place", "tp", "norms",
                                 "streams"])
    return launch(2, job, timeout=120)


def test_sharded_gallery_topk_matches_jax_and_dense(inputs, world2):
    import jax.numpy as jnp
    from reid_tpu.parallel import make_mesh
    from reid_tpu.parallel import sharded_gallery_topk as jtopk
    from reid_tpu_torch.ops.distance import topk_neighbors

    q, g, k = inputs["topk"]
    jd, ji = (np.asarray(a) for a in jtopk(make_mesh(2), jnp.asarray(q),
                                           jnp.asarray(g), k))
    for rank in world2:
        d, i = (t.numpy() for t in rank["topk"])
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(i, ji)
    dd, di = topk_neighbors(torch.from_numpy(q), torch.from_numpy(g), k)
    np.testing.assert_array_equal(world2[0]["topk"][1].numpy(), di.numpy())
    np.testing.assert_allclose(world2[0]["topk"][0].numpy(), dd.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_sharded_jaccard_matches_jax_and_world1(inputs, world2):
    import jax.numpy as jnp
    from reid_tpu.ops.rerank import compute_jaccard_distance_sharded as jsh
    from reid_tpu.parallel import make_mesh
    from reid_tpu_torch.ops.rerank import (compute_jaccard_distance,
                                           compute_jaccard_distance_sharded)

    for c, (f, k1, k2, s) in enumerate(inputs["jaccard"]):
        # JAX's sharded program on the padded cases (N = 63); the k2 = 1
        # case (N = 64) against the port's own world 1 and dense path
        want = None if len(f) % 2 == 0 else np.asarray(jsh(
            make_mesh(2), jnp.asarray(f), k1=k1, k2=k2, sparse_s=s))
        one = compute_jaccard_distance_sharded(
            None, torch.from_numpy(f), k1=k1, k2=k2, sparse_s=s).numpy()
        dense = compute_jaccard_distance(torch.from_numpy(f), k1=k1, k2=k2,
                                         sparse_s=s).numpy()
        np.testing.assert_array_equal(one, dense)
        for rank in world2:
            got = rank["jaccard"][c]
            assert got.shape == (len(f), len(f))
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(got, one)
    # "ivf" on a mesh: the sharded top-S sparse min-sum, exact here
    for rank in world2:
        np.testing.assert_array_equal(rank["jaccard"][-1],
                                      world2[0]["jaccard"][0])


def test_place_batch_and_replicate(inputs, world2):
    batch = inputs["batch"]
    for r, rank in enumerate(world2):
        placed = rank["place"]["placed"]
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_array_equal(placed["images"].numpy(),
                                      batch["images"][rows])
        np.testing.assert_array_equal(placed["labels"].numpy(),
                                      batch["labels"][rows])
        # not a per-sample key: whole on every rank
        np.testing.assert_array_equal(placed["flip_u"].numpy(),
                                      batch["flip_u"])
        np.testing.assert_array_equal(rank["place"]["sharded"]["x"].numpy(),
                                      batch["images"][rows])
        tree = rank["place"]["replicated"]
        assert torch.equal(tree["w"], torch.zeros((3, 2)))
        assert torch.equal(tree["b"][0], torch.arange(4))
        assert torch.equal(tree["b"][1], torch.tensor([True, True]))


def test_shard_params_tp_follows_jax_rules(world2):
    import jax.numpy as jnp
    from reid_tpu.parallel import make_mesh_2d
    from reid_tpu.parallel import shard_params_tp as jtp

    placed = jtp(make_mesh_2d(1, 2), {k: jnp.zeros(s)
                                      for k, s in TP_SHAPES.items()},
                 min_size=1024)
    for rank in world2:
        tp = rank["tp"]
        for k, arr in placed.items():
            spec = tuple(arr.sharding.spec) + (None,) * (2 - len(
                arr.sharding.spec))
            want = ("model_1" if spec[:2] == (None, "model") else "model_0"
                    if spec[:1] == ("model",) else "none")
            assert tp["specs"][k] == ["none", want], (k, tp["specs"][k])
        # column-parallel matmul: each rank holds half the columns
        assert tp["local"] == (256, 256)
        assert tp["out_placements"][1] == "model_1"
        np.testing.assert_allclose(tp["out"].numpy(), 256.0)
        assert tuple(tp["out"].shape) == (8, 512)


@pytest.mark.parametrize("which", [0, 1], ids=["batchnorm", "batchrenorm"])
def test_global_batch_norms_world2_match_world1(inputs, world2, which):
    from reid_tpu_torch.models.layers import BatchNorm, BatchRenorm

    want = norm_step((BatchNorm, BatchRenorm)[which], None, inputs["norms"])
    got = [torch.cat([world2[0]["norms"][which][i],
                      world2[1]["norms"][which][i]]) if i in (0, 3)
           else world2[0]["norms"][which][i] for i in range(4)]
    for name, g, w in zip(("y", "running_mean", "running_var", "dx"), got,
                          want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= 1e-6 * scale, (name, err, scale)
    # both ranks hold the same running statistics
    for i in (1, 2):
        assert torch.equal(world2[0]["norms"][which][i],
                           world2[1]["norms"][which][i])


def test_stream_tracker_mesh_matches_one_process(inputs, world2):
    want = run_streams(None, *inputs["streams"])
    assert want["valid"].sum() > 3 * 16
    for rank in world2:
        got = rank["streams"]
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["tlwh"], want["tlwh"])
