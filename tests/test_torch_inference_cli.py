"""The retrieval slice as a whole: the port's `inference_main` against the
JAX package's `inference_main` on the same Market-style JPEG tree (80x40
inputs: the XLA:CPU conv cliff) and the same random f32 weights (an orbax
checkpoint for JAX, its `.npz` for the port), with re-ranking (the
default), with `--no-rerank`, with `--int8` (the JAX kernel routes
forced on through their references; each side calibrates on its own),
with `--search_option sparse` and `ivf` (the port's k-means starts from
JAX's rows), with `--attributes_mat` (a `.mat` written with savemat), and
with `--artifact`: each package serves its own artifact of the same
weights (StableHLO for JAX, a torch.export `.pt2` for the port), in f32
and in int8 (each side calibrated on the CLI's calibration batch).

Without `--int8`, JAX's `inference_main` restores each checkpoint into
one train state built once for the module (`share_jax_state`), as the
port's reads the `.npz` into its model. Tolerance: CMC identical at every rank and mAP
within 1e-6 (measured equal). Both packages decode the tree's JPEGs to the same arrays (checked
in the fixture), so both embed the same pixels.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_retrieval import write_market_tree
from test_torch_train_data import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def jax_state():
    """The random f32 train state whose variables both packages serve."""
    import reid_tpu.config as jcfg
    from reid_tpu.models import build_model as jbuild
    from reid_tpu.train.state import create_train_state

    cfg = jcfg.Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=6))
    return create_train_state(jax.random.PRNGKey(0),
                              jbuild("seres18", num_classes=6, num_cams=6),
                              cfg, 1, input_shape=(2, 80, 40, 3))


@pytest.fixture(scope="module")
def tree_and_weights(tmp_path_factory, jax_state):
    from reid_tpu.data import ReIDDataset as JDataset
    from reid_tpu.utils import save_checkpoint
    from reid_tpu_torch.data import ReIDDataset, build_dataset
    from reid_tpu_torch.utils.flax_bridge import save_npz

    tmp = tmp_path_factory.mktemp("market")
    root = write_market_tree(str(tmp / "market"))
    raw = build_dataset("market1501", root, verbose=False)
    for split in (raw.query, raw.gallery):
        idx = np.arange(len(split))
        np.testing.assert_array_equal(
            ReIDDataset(split, 6, 80, 40).gather(idx)["images"],
            JDataset(split, 6, 80, 40).gather(idx)["images"])
    state = jax_state
    ckpt = save_checkpoint(str(tmp / "ckpt"), state)
    npz = str(tmp / "init.npz")
    save_npz(npz, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                   "batch_stats": jax.tree_util.tree_map(
                       np.asarray, state.batch_stats)})
    return root, ckpt, npz


def write_attributes(path):
    """A market_attribute.mat over the tree's ids (and one id it lacks):
    age and two binary attributes, as tests/test_eval.py writes one."""
    from scipy import io as scipy_io
    rng = np.random.default_rng(3)
    ids = [2, 5, 7, 11, 13, 17, 23]
    table = {
        "image_index": np.asarray([[f"{i:04d}" for i in ids]], dtype=object),
        "age": rng.integers(1, 5, (1, len(ids))).astype(float),
        "backpack": rng.integers(1, 3, (1, len(ids))).astype(float),
        "gender": rng.integers(1, 3, (1, len(ids))).astype(float),
    }
    scipy_io.savemat(path, {"market_attribute": {"test": table,
                                                 "train": table}})
    return path


def jax_int8_routes(monkeypatch):
    """The JAX int8 path through both kernel references."""
    import reid_tpu.utils.quantize as jqz
    from test_torch_quantize import force_jax_routes
    calls = force_jax_routes(monkeypatch)
    # keep the SE fc kernels the fused route reads (see
    # test_torch_retrieval.py)
    monkeypatch.setattr(jqz, "prune_quantized_kernels", lambda p, q: p)
    return calls


def share_jax_state(monkeypatch, state):
    """JAX's `inference_main` builds its state with `create_train_state`
    (PRNGKey(0), SERes18 of 6 classes at 80x40) before it restores the
    checkpoint into it: it gets `jax_state`, built by that same call once
    for the module. Its `apply_fn` is then one object in every case, so
    the jitted embeds of the JAX package compile once. Not under
    `--int8`: the quantization interceptor acts while a function is
    traced, and the inner jitted embed of an earlier case would be
    reused untraced (the f32 program)."""
    import reid_tpu.train.state as jstate

    def create_train_state(key, model, cfg, steps_per_epoch,
                           input_shape=None):
        assert (model.num_classes, tuple(input_shape)) == (6, (2, 80, 40, 3))
        return state
    monkeypatch.setattr(jstate, "create_train_state", create_train_state)


def export_both(root, state, npz, tmp, int8):
    """Each package's serving artifact of the same weights (`state`, whose
    variables `npz` holds); under `int8` each calibrates on the CLI's
    calibration batch (the first 8 gallery images at --bs 8)."""
    from reid_tpu.data import ReIDDataset as JDataset
    from reid_tpu.data import build_dataset as jbuild_dataset
    from reid_tpu.eval.serving import export_reid_artifact as jexport
    from reid_tpu_torch.eval.serving import export_reid_artifact
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import load_flax_variables

    raw = jbuild_dataset("market1501", root)
    calib = JDataset(raw.gallery, 6, 80, 40).gather(np.arange(8))["images"]
    jpath, tpath = str(tmp / "reid.stablehlo"), str(tmp / "reid.pt2")
    jexport(state, jpath, 80, 40, int8_calib=calib if int8 else None)
    model = build_model("seres18", num_classes=6, num_cams=6,
                        dtype=torch.float32, device="cpu")
    load_flax_variables(model, npz)
    export_reid_artifact(model, tpath, 80, 40,
                         int8_calib=torch.from_numpy(calib) if int8
                         else None)
    return jpath, tpath


@pytest.mark.parametrize("extra", [
    [], ["--no-rerank"], ["--int8"], ["--search_option", "sparse"],
    ["--artifact", "f32"], ["--artifact", "int8"],
    ["--search_option", "ivf"], ["--attributes_mat"]])
def test_inference_main_matches_jax(tree_and_weights, jax_state, extra,
                                    monkeypatch, tmp_path):
    from reid_tpu.cli import inference_main as jax_inference_main
    from reid_tpu_torch.cli import inference_main

    root, ckpt, npz = tree_and_weights
    flags = ["--root", root, "--height", "80", "--width", "40", "--bs", "8"]
    jax_only, port_only = ["--ckpt", ckpt], ["--ckpt", npz]
    int8 = "--int8" in extra or extra == ["--artifact", "int8"]
    if not int8:
        share_jax_state(monkeypatch, jax_state)
    if int8:
        calls = jax_int8_routes(monkeypatch)
    if extra and extra[0] == "--artifact":
        jpath, tpath = export_both(root, jax_state, npz, tmp_path, int8)
        jax_only, port_only = ["--artifact", jpath], ["--artifact", tpath]
    elif extra == ["--attributes_mat"]:
        flags += extra + [write_attributes(str(tmp_path / "attr.mat"))]
    else:
        flags += extra
    if extra == ["--search_option", "ivf"]:
        from reid_tpu_torch.ops import kmeans as tkm

        def jax_rows(n, k, generator=None):
            return torch.tensor(np.asarray(jax.random.choice(
                jax.random.PRNGKey(0), n, (k,), replace=False)))
        monkeypatch.setattr(tkm, "init_indices", jax_rows)
    cmc_j, map_j = jax_inference_main(flags + jax_only)
    if int8:
        assert calls["qconv"] > 0 and calls["qblock"] > 0
    cmc_t, map_t = inference_main(flags + port_only, device="cpu")
    assert cmc_t.shape == (50,)
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6, (map_t, map_j)


@pytest.mark.parametrize("extra", [
    pytest.param([], id="extra3"),
    pytest.param(["--artifact", "a.pt2", "--int8"], id="artifact_int8")])
def test_later_slice_flags_raise(tmp_path, extra):
    """A run without weights (neither --ckpt nor --artifact), and --int8
    with an artifact (export an int8 artifact instead, as the JAX package
    says), stop at the parser."""
    from reid_tpu_torch.cli import inference_main
    with pytest.raises(SystemExit):
        inference_main(["--root", str(tmp_path), *extra], device="cpu")


def test_inference_restores_tf32_flags(tree_and_weights, monkeypatch):
    """The retrieval entry runs in full f32 and gives the caller's TF32
    settings back."""
    import torch

    from reid_tpu_torch.cli import inference_main
    seen = []
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr("reid_tpu_torch.eval.inference.run_inference",
                        lambda *a, **k: seen.append(
                            (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32)))
    root, _, npz = tree_and_weights
    inference_main(["--root", root, "--ckpt", npz, "--height", "80",
                    "--width", "40"], device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
