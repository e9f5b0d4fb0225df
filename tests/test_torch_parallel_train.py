"""Data-parallel training and sharded retrieval of the port against its
own world 1 and the JAX package's mesh of 2, on the CPU.

The port's world 2 runs in two gloo subprocess ranks (`torch_ranks`, one
launch for the file, 120 s at most); world 1 runs in this process and
JAX (`make_mesh(2)` of its 8 virtual CPU devices) here too, at
tests/test_parallel.py:80-135's sizes:

  * `train_cnn(mesh=)`: SERes18 in f32 at 80x40, 16 images of 4 ids, PK
    batches of 8 = 4 x 2, one epoch (two steps) from one carried state,
    JAX's augmentation draws replayed on both packages. Per-step losses
    of world 2 within 1e-5 relative of world 1 and within 1e-4 of JAX's
    `train_cnn(mesh=make_mesh(2))` (the limit tests/test_torch_train_cli.py
    holds the one-device loop to); both ranks end with the same weights,
    and only rank 0 writes the checkpoint;
  * `run_inference(mesh=)` with re-ranking on 6 queries and 13 gallery
    images (N = 19, padded to 20): mAP within 1e-4 of the meshless run;
  * a step of the video train step (`video_resnet50` with one block a
    stage, four 2 x 32 x 16 clips of two ids) at world 2 against world 1:
    the loss within 1e-5 relative, MADGRAD's summed gradient within 1e-4
    of its norm (read 1.7e-5: world 2 sums each gradient from two
    partial backward passes, and train-mode norms over two clips of
    2 x 32 x 16 amplify the rounding; MADGRAD, like Adam, moves an
    element whose gradient is rounding noise by about lr either way, so
    the weights are held through the gradient), the centers within
    1e-5 of their largest value; both ranks hold the same weights;
  * `cli.train_main` (bf16, as under `torchrun`) on three ranks, whose
    count does not divide the batch of 8: `fit_mesh` keeps ranks 0-1,
    which end bit-equal to the world-2 run, and rank 2 says in one line
    that it sits the run out and returns without training or writing a
    file (its launch exits 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train_data import (place_seeded_luts,  # noqa: F401
                                   two_torch_threads)
from torch_ranks import launch, run_retrieval, run_train_cnn, run_video_step

H, W, C, B = 80, 40, 4, 8


def configs():
    import reid_tpu.config as jcfg
    import reid_tpu_torch.config as tcfg
    train = dict(batch_size=B, num_instances=2, epochs=1, lr=1e-4,
                 warmup_epochs=1, hold_epochs=2)
    data = dict(height=H, width=W, pad=0, flip_prob=0.0,
                random_erasing_prob=0.0)
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), num_classes=C,
                                  dtype="float32"),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(num_classes=C, dtype="float32"),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    return jc, tc


@pytest.fixture(scope="module")
def train_job():
    """The carried state (the port's seeded init, random centers and unit
    DCC rows) as numpy, JAX's draws of each step, the configurations."""
    import jax
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables
    from test_torch_train_data import jax_augment_draws
    from test_torch_train_step import jax_state

    jc, tc = configs()
    variables = flax_variables(build_model(
        "seres18", num_classes=C, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    js = jax_state(variables, jc, num_classes=C)
    key, draws = jax.random.PRNGKey(jc.train.seed + 1), []
    for _ in range(16 // B):
        key, k = jax.random.split(key)
        draws.append({n: v.numpy() for n, v in jax_augment_draws(
            k, B, H, W, jc.data.pad).items()})
    return {"config": tc, "jax_config": jc, "jax_state": js,
            "variables": variables, "draws": draws,
            "centers": np.asarray(js.loss_state.centers),
            "dcc": [np.asarray(js.loss_state.dcc.lut_ccc),
                    np.asarray(js.loss_state.dcc.lut_icc)],
            "dataset": dict(n=16, num_pids=C, height=H, width=W)}


def retrieval_job():
    import reid_tpu_torch.config as tcfg
    cfg = tcfg.Config(
        model=tcfg.ModelConfig(num_classes=4, dtype="float32"),
        train=tcfg.TrainConfig(batch_size=8, num_instances=2, epochs=1),
        data=tcfg.DataConfig(height=H, width=W),
        retrieval=tcfg.RetrievalConfig(k1=6, k2=2, dbscan_min_samples=2))
    return {"config": cfg,
            "query": dict(n=6, num_pids=3, height=H, width=W, seed=1),
            "gallery": dict(n=13, num_pids=3, height=H, width=W, seed=2)}


def video_job():
    rng = np.random.default_rng(7)
    return {"classes": 2, "batches": [
        (rng.uniform(0, 1, size=(4, 2, 32, 16, 3)).astype(np.float32),
         np.array([0, 0, 1, 1], np.int32))]}


# train_main's run: 16 images of 4 ids at 64x32, one epoch of two PK
# batches of 8 = 4 x 2
TRAIN_MAIN = {"tree": dict(num_pids=4, per_id=4, height=64, width=32,
                           query_per_id=1, gallery_per_id=1),
              "flags": ["--epochs", "1", "--bs", "8", "--instance", "2",
                        "--height", "64", "--width", "32"]}


@pytest.fixture(scope="module")
def world2(train_job):
    job = {"programs": ["train_cnn", "inference", "video", "train_main"],
           "train_cnn": {k: train_job[k] for k in (
               "config", "variables", "draws", "centers", "dcc",
               "dataset")},
           "inference": retrieval_job(), "video": video_job(),
           "train_main": TRAIN_MAIN}
    return launch(2, job, timeout=120)


@pytest.fixture(scope="module")
def world3():
    return launch(3, {"programs": ["train_main"], "train_main": TRAIN_MAIN},
                  timeout=120)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / np.abs(want))


def test_train_cnn_world2_matches_world1_and_jax(train_job, world2,
                                                 tmp_path, monkeypatch):
    from reid_tpu.parallel import make_mesh
    from reid_tpu.train.image_train import train_cnn as jtrain_cnn
    from reid_tpu.data.dataset import synthetic_dataset as jsynthetic
    import reid_tpu.utils as jutils
    from reid_tpu_torch.train import steps

    keep = steps.augment_draws
    try:
        one = run_train_cnn(None, {"train_cnn": train_job},
                            str(tmp_path / "t"))
    finally:
        steps.augment_draws = keep
    # the JAX loop ends with an orbax checkpoint, which is not compared
    monkeypatch.setattr(jutils, "save_checkpoint", lambda path, state: path)
    place_seeded_luts(monkeypatch)
    _, jloss = jtrain_cnn(train_job["jax_config"], jsynthetic(
        n=16, num_pids=C, height=H, width=W), state=train_job["jax_state"],
        log_every=1, ckpt_dir=str(tmp_path / "j"), mesh=make_mesh(2))
    assert len(one["losses"]) == len(jloss) == 2
    assert rel(one["losses"], jloss) < 1e-4
    for rank in world2:
        got = rank["train_cnn"]
        assert rel(got["losses"], one["losses"]) < 1e-5
        assert rel(got["losses"], jloss) < 1e-4
        for a, b in zip(got["params"], world2[0]["train_cnn"]["params"]):
            assert torch.equal(a, b)
        for a, b in zip(got["params"], one["params"]):
            assert float((a - b).abs().max()) <= 1e-5 * max(
                float(b.abs().max()), 1.0)
        assert torch.equal(got["centers"],
                           world2[0]["train_cnn"]["centers"])
    assert world2[0]["train_cnn"]["files"] == [
        "cnn_net_checkpoint_market1501.npz"]
    assert world2[1]["train_cnn"]["files"] == []


def test_run_inference_mesh_matches_meshless(world2):
    want = run_retrieval(None, {"inference": retrieval_job()})
    assert 0.0 <= want["mAP"] <= 1.0
    for rank in world2:
        got = rank["inference"]
        assert abs(got["mAP"] - want["mAP"]) < 1e-4
        np.testing.assert_allclose(got["cmc"], want["cmc"], atol=1e-4)


def flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors]).double()


def test_video_step_world2_matches_world1(world2):
    want = run_video_step(None, {"video": video_job()})
    g_want = flat(want["grad_sum"])
    for rank in world2:
        got = rank["video"]
        assert rel(got["losses"], want["losses"]) < 1e-5
        # MADGRAD's first step sums the gradient itself
        err = float((flat(got["grad_sum"]) - g_want).norm())
        assert err <= 1e-4 * float(g_want.norm()), err
        assert float((got["centers"] - want["centers"]).abs().max()) \
            <= 1e-5 * float(want["centers"].abs().max())
        for a, b in zip(got["params"], world2[0]["video"]["params"]):
            assert torch.equal(a, b)


def test_train_main_world3_group_matches_world2(world2, world3):
    """Ranks 0-1 of three train as a world of two; rank 2 sits it out."""
    for r in (0, 1):
        got, want = world3[r]["train_main"], world2[r]["train_main"]
        assert got["trained"] and want["trained"]
        assert len(got["params"]) == len(want["params"]) > 0
        for a, b in zip(got["params"], want["params"]):
            assert torch.equal(a, b)
        assert got["files"] == want["files"]
        assert "data parallel over 2 rank(s) of the process group" in \
            got["printed"]
    assert world3[0]["train_main"]["files"] == [
        "cnn_net_checkpoint_market1501.npz"]
    out = world3[2]["train_main"]
    assert not out["trained"] and out["files"] == [] and out["params"] == []
    assert out["printed"] == [
        "rank 2 of 3 sits this run out: the batch of 8 divides over the "
        "first 2 rank(s) (fit_mesh)"]
