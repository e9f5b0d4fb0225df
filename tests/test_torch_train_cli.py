"""The training slice as a whole.

  * `train_cnn` of the port against the JAX package's, one epoch from one
    carried state on the same in-memory split (8 ids x 4 images at 32x16,
    PK batches of 8 = 4 x 2), augmentation off as far as the
    configuration turns it off (pad 0, flip 0, erasing 0); the gray fuse
    the train step keeps on draws from JAX's keys on both sides. The DCC
    tables seeded from the eval logits' class means within 1e-5; the
    loss of every step within 1e-4 relative (f32). The lr stays at 1e-4,
    so the elements whose gradient is rounding noise (which Adam moves by
    about lr either way; test_torch_train_step.py) move the loss far less
    than that.
  * The port's `train_main --continual --export` on a tiny Market-style
    JPEG tree (4 ids x 8 images, queries and gallery) with a
    DukeMTMC-style target (3 ids x 12 images), in bf16, one epoch
    of each phase (the continual phase's 40 epochs cut to 1): pseudo
    records with the source's class count as offset, the classifier,
    centers and tables widened by the clusters found, the `.npz`
    checkpoint read back by `inference_main --ckpt`, the `.pt2` artifact
    serving the trained model's embeddings.
  * `expand_classifier` against the JAX package's on one carried state:
    the widened kernel, centers and DCC tables bit-equal, the other
    variables unchanged, fresh optimizer state (JAX's fresh state built
    without the flax init it discards).

oneDNN's bf16 convolution on this CPU returns NaN now and then in a
process where XLA:CPU has run, so the bf16 run uses ATen's own
convolution."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import reid_tpu.config as jcfg
import reid_tpu_torch.config as tcfg
from reid_tpu.data.dataset import synthetic_dataset as jsynthetic
from reid_tpu_torch.data.dataset import synthetic_dataset
from reid_tpu_torch.utils.flax_bridge import (torch_state_dict,
                                              train_state_from_flax)
from test_torch_train_data import (jax_augment_draws,  # noqa: F401
                                   place_seeded_luts, two_torch_threads)
from test_torch_train_step import jax_state

H, W, C, B = 32, 16, 8, 8


def configs(**train):
    train = dict(batch_size=B, num_instances=2, epochs=1, **train)
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
def variables():
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables
    return flax_variables(build_model(
        "seres18", num_classes=C, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0)))


def test_train_cnn_matches_jax_loss_trace(variables, tmp_path, monkeypatch):
    from reid_tpu.parallel import make_mesh
    from reid_tpu.train.image_train import seed_dcc_luts as jseed
    from reid_tpu.train.image_train import train_cnn as jtrain_cnn
    from reid_tpu_torch.train import steps
    from reid_tpu_torch.train.image_train import seed_dcc_luts, train_cnn

    jc, tc = configs(lr=1e-4, warmup_epochs=1, hold_epochs=2)
    js = jax_state(variables, jc, num_classes=C)
    ts = train_state_from_flax(js, tc, 1, device="cpu")
    # the train loop's augmentation keys: split from seed + 1, step by step
    keys = [jax.random.PRNGKey(jc.train.seed + 1)]

    def jax_draws(generator, b, h, w, pad=10, device="cpu"):
        keys[0], k = jax.random.split(keys[0])
        return jax_augment_draws(k, b, h, w, pad)
    monkeypatch.setattr(steps, "augment_draws", jax_draws)
    # the JAX loop ends with an orbax checkpoint, which the comparison does
    # not read (importing orbax alone takes seconds)
    import reid_tpu.utils as jutils
    monkeypatch.setattr(jutils, "save_checkpoint", lambda path, state: path)
    place_seeded_luts(monkeypatch)
    jds = jsynthetic(n=32, num_pids=C, height=H, width=W)
    tds = synthetic_dataset(n=32, num_pids=C, height=H, width=W)
    # the epoch-0 seeding of the DCC tables, which train_cnn repeats
    seeded = jseed(js, jds, B, C).loss_state.dcc
    for got, want in zip(seed_dcc_luts(ts, tds, B, C).loss_state.dcc,
                         seeded):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    js, jloss = jtrain_cnn(jc, jds, state=js, log_every=1,
                           ckpt_dir=str(tmp_path / "j"), mesh=make_mesh(1))
    ts, tloss = train_cnn(tc, tds, state=ts, log_every=1,
                          ckpt_dir=str(tmp_path / "t"), device="cpu")
    assert len(tloss) == len(jloss) >= 3
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert os.listdir(tmp_path / "t") == ["cnn_net_checkpoint_market1501.npz"]


def test_expand_classifier_matches_jax(variables, monkeypatch):
    import reid_tpu.train.image_train as jimage_train
    from reid_tpu.train.image_train import expand_classifier as jexpand
    from reid_tpu_torch.train.image_train import expand_classifier

    jc, tc = configs()
    js = jax_state(variables, jc, num_classes=C)

    def fresh_state(key, model, cfg, steps_per_epoch, input_shape):
        # `create_train_state` without its flax init, whose random params
        # expand_classifier replaces (compiling that init alone takes
        # seconds)
        params = dict(js.params, classifier={"kernel": np.zeros(
            (512, model.num_classes), np.float32)})
        return jax_state({"params": params,
                          "batch_stats": js.batch_stats}, cfg,
                         num_classes=model.num_classes)
    monkeypatch.setattr(jimage_train, "create_train_state", fresh_state)
    ts = train_state_from_flax(js, tc, 1, device="cpu")
    centroids = np.random.default_rng(0).normal(
        size=(3, 512 + C)).astype(np.float32)
    for cents in (centroids, None):
        jnew, jcfg_new = jexpand(js, jc, 3, cents)
        tnew, tcfg_new = expand_classifier(ts, tc, 3, cents)
        assert jcfg_new.model.num_classes == tcfg_new.model.num_classes \
            == C + 3
        sd = torch_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jnew.params), "batch_stats": jax.tree_util.tree_map(
                np.asarray, jnew.batch_stats)})
        got = tnew.model.state_dict()
        assert got.keys() == sd.keys()
        for k in sd:
            np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy(),
                                          err_msg=k)
        np.testing.assert_array_equal(tnew.loss_state.centers.numpy(),
                                      np.asarray(jnew.loss_state.centers))
        for a, b in zip(tnew.loss_state.dcc, jnew.loss_state.dcc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tnew.step == 0 and tnew.opt_state["count"] == 0
        assert not any(m.any() for m in tnew.opt_state["mu"])


def test_train_main_continual_export(tmp_path, monkeypatch):
    from reid_tpu_torch.cli import inference_main, train_main
    from reid_tpu_torch.data.datasets import write_synthetic_tree
    from reid_tpu_torch.eval.serving import load_serving_fn, make_embed_fn
    from reid_tpu_torch.train import image_train
    from reid_tpu_torch.utils.flax_bridge import load_npz

    market = write_synthetic_tree(str(tmp_path / "market"), "market1501", 4,
                                  8, H, W, query_per_id=2, gallery_per_id=3)
    duke = write_synthetic_tree(str(tmp_path / "duke"), "dukemtmc", 3, 12,
                                H, W, num_cams=8, seed=1)
    seen = {}
    continual = image_train.train_continual

    def one_epoch(cfg, state, source, records, centroids, k, **kw):
        seen.update(records=records, centroids=centroids, k=k,
                    classes=cfg.model.num_classes)
        return continual(cfg, state, source, records, centroids, k,
                         epochs=1, **kw)
    monkeypatch.setattr(image_train, "train_continual", one_epoch)
    pt2 = str(tmp_path / "reid.pt2")
    ckpt_dir = str(tmp_path / "ckpt")
    with torch.backends.mkldnn.flags(enabled=False):
        state = train_main(
            ["--root", market, "--epochs", "1", "--bs", "8", "--instance",
             "2", "--height", str(H), "--width", str(W), "--continual",
             "--target_root", duke, "--export", pt2], device="cpu",
            ckpt_dir=ckpt_dir)
    k = seen["k"]
    assert 1 <= k <= 3 and seen["classes"] == 4
    pids = {r[1] for r in seen["records"]}
    assert pids == set(range(4, 4 + k))
    assert len(seen["records"]) >= 10 * k
    assert seen["centroids"].shape == (k, 512 + 4)
    n = 4 + k
    assert state.model.classifier.weight.shape == (n, 512)
    assert state.loss_state.centers.shape == (n, 512)
    assert all(t.shape == (n, n) for t in state.loss_state.dcc)
    for p in state.model.parameters():
        assert torch.isfinite(p).all()

    npz = os.path.join(ckpt_dir, "cnn_net_checkpoint_market1501.npz")
    assert load_npz(npz)["params"]["classifier"]["kernel"].shape == \
        (512, n)
    cmc, mean_ap = inference_main(["--root", market, "--ckpt", npz,
                                   "--height", str(H), "--width", str(W),
                                   "--bs", "8"], device="cpu")
    assert cmc.shape == (50,) and np.isfinite(cmc).all()
    assert 0.0 < mean_ap <= 1.0

    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (3, H, W, 3)).astype(np.float32))
    with torch.backends.mkldnn.flags(enabled=False):
        want = make_embed_fn(state.model)(x)
        got = load_serving_fn(pt2)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
