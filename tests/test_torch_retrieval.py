"""The retrieval modules of the port against `reid_tpu` on the CPU: camera
de-bias, tracklet smoothing, DBSCAN, CMC/mAP, the dataset parsers, the
image store and loader, the TTA embedding and the int8 serving embed.

Tolerances:
  * diminish_camera_bias: atol = 1e-5 (the inverse Gram matrix rounds
    differently in LAPACK and XLA);
  * smooth_tracklets: atol = 1e-6 (0/1 matmuls sum the tracklets in
    another order than `segment_sum`);
  * DBSCAN labels, parsed records, synthetic and decoded images, loader
    batches, config defaults: identical;
  * evaluate_all / evaluate_rerank: CMC identical and mAP within 1e-6, on
    distances that tie in large groups;
  * inference_batch: identical; embed_with_flip / extract_embeddings of the
    f32 SERes18: atol = 1e-5;
  * the int8 serving embed, each side calibrated on its own, the JAX kernel
    routes forced on through their references: cosine >= 0.999 per row.
    The JAX serving embed replaces every quantized kernel in its params
    with a placeholder (`prune_quantized_kernels`), the SE fcs included,
    which its fused-block route then reads: with that route on, the JAX
    serving embed fails. The test keeps the kernels (a monkeypatch; the
    interceptor reads them from the QuantState either way).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.config as jcfg
from reid_tpu.data import ReIDDataset as JDataset
from reid_tpu.data import build_dataset as jbuild_dataset
from reid_tpu.data import synthetic_dataset as jsynthetic
from reid_tpu.data.loader import make_eval_loader as jloader
from reid_tpu.data.transforms import inference_batch as jinference_batch
from reid_tpu.eval.cmc_map import evaluate_all as jeval_all
from reid_tpu.eval.cmc_map import evaluate_rerank as jeval_rerank
from reid_tpu.models import build_model as jbuild_model
from reid_tpu.ops import dbscan_precomputed as jdbscan
from reid_tpu.ops import diminish_camera_bias as jdebias
from reid_tpu.ops import smooth_tracklets as jsmooth
from reid_tpu.train.image_train import extract_embeddings as jextract
from reid_tpu.train.state import create_train_state
from reid_tpu.train.steps import embed_with_flip as jembed_with_flip
from reid_tpu_torch import config as tcfg
from reid_tpu_torch.data import ReIDDataset, build_dataset, synthetic_dataset
from reid_tpu_torch.data import dataset as tdataset
from reid_tpu_torch.data.loader import make_eval_loader
from reid_tpu_torch.data.transforms import inference_batch
from reid_tpu_torch.eval.cmc_map import evaluate_all, evaluate_rerank
from reid_tpu_torch.models import build_model
from reid_tpu_torch.ops import camera as tcamera
from reid_tpu_torch.ops.camera import diminish_camera_bias, smooth_tracklets
from reid_tpu_torch.ops.dbscan import dbscan_precomputed
from reid_tpu_torch.train.image_train import extract_embeddings
from reid_tpu_torch.train.steps import embed_with_flip
from reid_tpu_torch.utils.flax_bridge import load_flax_variables
from test_torch_train_data import two_torch_threads  # noqa: F401

COLORS = [(220, 40, 40), (40, 220, 40), (40, 40, 220), (200, 200, 40),
          (40, 200, 200), (200, 40, 200)]


def write_market_tree(root, h=64, w=32, seed=1):
    """A Market-1501-style JPEG tree: 6 ids; train 3 images each (cams
    1-3), query 2 each (cams 4, 5), gallery 4 each (cams 1, 2, 3, 6) plus
    two junk (-1) and two distractor (0000) images."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    pids = [2, 5, 7, 11, 13, 17]
    specs = {
        "bounding_box_train": [(p, c) for p in pids for c in (1, 2, 3)],
        "query": [(p, c) for p in pids for c in (4, 5)],
        "bounding_box_test": [(p, c) for p in pids for c in (1, 2, 3, 6)]
        + [(-1, 1), (-1, 2), (0, 3), (0, 4)],
    }
    for sub, items in specs.items():
        d = os.path.join(root, sub)
        os.makedirs(d)
        for k, (pid, cam) in enumerate(items):
            color = COLORS[pids.index(pid)] if pid > 0 else (128, 128, 128)
            base = np.zeros((h, w, 3), int) + color
            arr = np.clip(base + rng.integers(-40, 40, base.shape), 0,
                          255).astype(np.uint8)
            name = (f"{pid:04d}" if pid >= 0 else "-1") + \
                f"_c{cam}s{1 + k % 3}_{k:06d}_00.jpg"
            Image.fromarray(arr).save(os.path.join(d, name))
    return str(root)


@pytest.fixture(scope="module")
def seres18_f32():
    """The f32 SERes18 as the JAX retrieval CLI builds it (6 ids, 80x40),
    and the port's copy with the same variables."""
    cfg = jcfg.Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=6))
    model = jbuild_model("seres18", num_classes=6, num_cams=6)
    state = create_train_state(jax.random.PRNGKey(0), model, cfg, 1,
                               input_shape=(2, 80, 40, 3))
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                       state.batch_stats)}
    tm = build_model("seres18", num_classes=6, num_cams=6, device="cpu")
    load_flax_variables(tm, variables)
    return state, variables, tm


def test_config_defaults_equal_jax():
    for name in ("RetrievalConfig", "ModelConfig", "TrainConfig",
                 "DataConfig"):
        mine = getattr(tcfg, name)()
        ref = getattr(jcfg, name)()
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), (name, f)
    assert len(dataclasses.fields(tcfg.RetrievalConfig)) == len(
        dataclasses.fields(jcfg.RetrievalConfig))


def test_camera_debias_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(90, 40)).astype(np.float32)
    cams = rng.integers(0, 4, 90)
    cams[cams == 2] = 3                     # a camera with no rows
    want = np.asarray(jdebias(jnp.asarray(x), jnp.asarray(cams),
                              num_cams=4))
    got = diminish_camera_bias(torch.from_numpy(x), torch.from_numpy(cams),
                               num_cams=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    got = diminish_camera_bias(torch.from_numpy(x),
                               torch.from_numpy(cams)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seg_block", [2048, 3])
def test_smooth_tracklets_matches_jax(seg_block, monkeypatch):
    """One block of tracklets, and blocks of 3 (sparse ids up to 40)."""
    monkeypatch.setattr(tcamera, "_SEG_BLOCK", seg_block)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    ids = rng.integers(-1, 9, 40) * 5
    want = np.asarray(jsmooth(jnp.asarray(x), jnp.asarray(ids)))
    got = smooth_tracklets(torch.from_numpy(x), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[ids < 0], x[ids < 0])
    none = np.full(40, -1)
    np.testing.assert_array_equal(
        smooth_tracklets(torch.from_numpy(x), torch.from_numpy(none)).numpy(),
        x)


def test_dbscan_labels_equal_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(size=(30, 3)) * 0.2 + c
                          for c in (0.0, 4.0, 8.0)] + [rng.normal(size=(15, 3))
                                                       * 4])
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    for eps, ms in ((0.5, 4), (0.8, 10), (0.3, 2)):
        np.testing.assert_array_equal(dbscan_precomputed(d, eps, ms),
                                      jdbscan(d, eps, ms))


def eval_inputs(rng, q=23, g=61):
    ql = rng.integers(0, 6, q)
    gl = np.concatenate([rng.integers(0, 6, g - 4), [-1, -1, 0, 3]])
    qc, gc = rng.integers(0, 3, q), rng.integers(0, 3, g)
    return ql, qc, gl, gc


def test_evaluate_rerank_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    ql, qc, gl, gc = eval_inputs(rng)
    # Jaccard-like: most pairs exactly 1.0, some exact 0s, few levels
    dist = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), (23, 61),
                      p=[0.05, 0.1, 0.15, 0.7]).astype(np.float32)
    cmc_j, map_j = jeval_rerank(jnp.asarray(dist), ql, qc, gl, gc,
                                verbose=False)
    cmc_t, map_t = evaluate_rerank(torch.from_numpy(dist), ql, qc, gl, gc,
                                   verbose=False)
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6


def test_evaluate_all_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    ql, qc, gl, gc = eval_inputs(rng)
    qf = rng.integers(-1, 2, (23, 5)).astype(np.float32)
    gf = rng.integers(-1, 2, (61, 5)).astype(np.float32)
    cmc_j, map_j = jeval_all(jnp.asarray(qf), ql, qc, jnp.asarray(gf), gl,
                             gc, verbose=False)
    cmc_t, map_t = evaluate_all(torch.from_numpy(qf), ql, qc,
                                torch.from_numpy(gf), gl, gc, verbose=False)
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6


@pytest.mark.parametrize("name", ["market1501", "dukemtmc", "veri"])
def test_dataset_parsers_match_jax(tmp_path, name):
    sub = {"market1501": ("", ("bounding_box_train", "query",
                               "bounding_box_test")),
           "dukemtmc": ("DukeMTMC-reID", ("bounding_box_train", "query",
                                          "bounding_box_test")),
           "veri": ("VeRi", ("image_train", "image_query", "image_test"))}
    top, dirs = sub[name]
    for i, d in enumerate(dirs):
        path = tmp_path / top / d
        path.mkdir(parents=True)
        for pid, cam in ((3, 1), (3, 2), (8, 4), (-1, 1), (12, 5)):
            (path / f"{pid:04d}_c{cam}s{i + 1}_000{cam}_00.jpg".replace(
                "-001", "-1")).write_bytes(b"")
    mine = build_dataset(name, str(tmp_path), verbose=False)
    ref = jbuild_dataset(name, str(tmp_path), verbose=False)
    for split in ("train", "query", "gallery"):
        assert getattr(mine, split) == getattr(ref, split)
    assert mine.num_train_pids == ref.num_train_pids
    with pytest.raises(KeyError):
        build_dataset("cuhk03", str(tmp_path))


def test_synthetic_dataset_equals_jax(monkeypatch):
    monkeypatch.setattr(tdataset, "_SYNTH_CHUNK", 8)
    kw = dict(n=37, num_pids=5, height=16, width=8, num_cams=3, seed=4,
              palette_seed=1)
    mine, ref = synthetic_dataset(**kw), jsynthetic(**kw)
    assert mine.records == ref.records
    for i in range(37):
        np.testing.assert_array_equal(mine.load_image(i), ref.load_image(i))


def test_decoded_images_equal_jax(tmp_path):
    """Both packages decode the same pixels from JPEG files: the native
    libjpeg loader where it builds, PIL otherwise."""
    root = write_market_tree(str(tmp_path))
    raw = build_dataset("market1501", root, verbose=False)
    mine = ReIDDataset(raw.gallery, 6, 80, 40)
    ref = JDataset(raw.gallery, 6, 80, 40)
    idx = np.arange(len(mine))
    np.testing.assert_array_equal(mine.gather(idx)["images"],
                                  ref.gather(idx)["images"])
    np.testing.assert_array_equal(ReIDDataset(raw.query, 6, 80, 40)
                                  .load_image(3),
                                  JDataset(raw.query, 6, 80, 40).load_image(3))


def test_eval_loader_matches_jax():
    ds = synthetic_dataset(n=23, num_pids=4, height=8, width=4, seed=2)
    jds = jsynthetic(n=23, num_pids=4, height=8, width=4, seed=2)
    mine = list(make_eval_loader(ds, 5, device="cpu"))
    ref = list(jloader(jds, 5))
    assert len(mine) == len(ref) == len(make_eval_loader(ds, 5, "cpu")) == 5
    for a, b in zip(mine, ref):
        for k in ("images", "labels", "cams", "seqs"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    # the last batch wraps to the start
    np.testing.assert_array_equal(mine[-1]["images"][3:].numpy(),
                                  mine[0]["images"][:2].numpy())
    # a consumer that stops early leaves no producer behind
    first = next(iter(make_eval_loader(ds, 5, device="cpu")))
    assert first["images"].shape == (5, 8, 4, 3)


def test_inference_batch_equals_jax():
    x = np.random.default_rng(5).integers(0, 256, (3, 20, 10, 3)).astype(
        np.uint8)
    for flipped in (False, True):
        want = np.asarray(jinference_batch(jnp.asarray(x), flipped=flipped))
        t = torch.from_numpy(x)
        got = inference_batch(torch.flip(t, dims=(2,)) if flipped else t)
        np.testing.assert_array_equal(got.numpy(), want)


def test_embeddings_match_jax(seres18_f32):
    state, _, tm = seres18_f32
    ds = synthetic_dataset(n=11, num_pids=3, height=80, width=40, seed=6)
    jds = jsynthetic(n=11, num_pids=3, height=80, width=40, seed=6)
    x = inference_batch(torch.from_numpy(ds.gather(np.arange(4))["images"]))
    want = np.asarray(jembed_with_flip(state.apply_fn, state.params,
                                       state.batch_stats,
                                       jnp.asarray(x.numpy())))
    with torch.inference_mode():
        got = embed_with_flip(tm, x).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        for tta in (True, False):
            want = jextract(state, jds, 4, tta_flip=tta)
            got = extract_embeddings(tm, ds, 4, tta_flip=tta, device="cpu")
            assert got.shape == want.shape == (11, 512 + 6)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_int8_serving_embed_matches_jax(seres18_f32, monkeypatch):
    from test_torch_quantize import force_jax_routes

    import reid_tpu.utils.quantize as jqz
    from reid_tpu.eval.serving import make_int8_embed_fn as jint8
    from reid_tpu_torch.eval.serving import make_int8_embed_fn
    from reid_tpu_torch.utils import quantize as tqz

    state, _, tm = seres18_f32
    imgs = synthetic_dataset(n=8, num_pids=4, height=80, width=40,
                             seed=7).gather(np.arange(8))["images"]
    calls = force_jax_routes(monkeypatch)
    monkeypatch.setattr(jqz, "prune_quantized_kernels", lambda p, q: p)
    want = np.asarray(jint8(state, jnp.asarray(imgs))(
        jnp.asarray(imgs, jnp.float32)))
    assert calls["qconv"] > 0 and calls["qblock"] > 0
    fn = make_int8_embed_fn(tm, torch.from_numpy(imgs))
    with torch.inference_mode():
        got = fn(torch.from_numpy(imgs).float()).numpy()
    assert got.shape == want.shape == (8, 512 + 6)
    cos = np.sum(got * want, axis=1)
    assert cos.min() >= 0.999, cos
    # the f32 trunk is served through both kernels' routes
    qm = tqz.quantized_model(tm, tqz.quantize(tm, [inference_batch(
        torch.from_numpy(imgs))]))
    assert isinstance(qm.block41, tqz.QSEBasicBlock)
    assert qm.block21.conv2.route
