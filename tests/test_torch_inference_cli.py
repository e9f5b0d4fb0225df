"""The retrieval slice as a whole: the port's `inference_main` against the
JAX package's `inference_main` on the same Market-style JPEG tree (80x40
inputs: the XLA:CPU conv cliff) and the same random f32 weights (an orbax
checkpoint for JAX, its `.npz` for the port), with re-ranking (the
default), with `--no-rerank`, and with `--int8` (the JAX kernel routes
forced on through their references; each side calibrates on its own).

Tolerance: CMC identical at every rank and mAP within 1e-6 (measured
equal). Both packages decode the tree's JPEGs to the same arrays (checked
in the fixture), so both embed the same pixels.
"""

import dataclasses

import jax
import numpy as np
import pytest

from test_torch_retrieval import write_market_tree


@pytest.fixture(scope="module")
def tree_and_weights(tmp_path_factory):
    import reid_tpu.config as jcfg
    from reid_tpu.data import ReIDDataset as JDataset
    from reid_tpu.models import build_model as jbuild
    from reid_tpu.train.state import create_train_state
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
    cfg = jcfg.Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=6))
    state = create_train_state(jax.random.PRNGKey(0),
                               jbuild("seres18", num_classes=6, num_cams=6),
                               cfg, 1, input_shape=(2, 80, 40, 3))
    ckpt = save_checkpoint(str(tmp / "ckpt"), state)
    npz = str(tmp / "init.npz")
    save_npz(npz, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                   "batch_stats": jax.tree_util.tree_map(
                       np.asarray, state.batch_stats)})
    return root, ckpt, npz


@pytest.mark.parametrize("extra", [[], ["--no-rerank"], ["--int8"],
                                   ["--search_option", "sparse"]])
def test_inference_main_matches_jax(tree_and_weights, extra, monkeypatch):
    from reid_tpu.cli import inference_main as jax_inference_main
    from reid_tpu_torch.cli import inference_main

    root, ckpt, npz = tree_and_weights
    flags = ["--root", root, "--height", "80", "--width", "40", "--bs", "8",
             *extra]
    if "--int8" in extra:
        import reid_tpu.utils.quantize as jqz
        from test_torch_quantize import force_jax_routes
        calls = force_jax_routes(monkeypatch)
        # keep the SE fc kernels the fused route reads (see
        # test_torch_retrieval.py)
        monkeypatch.setattr(jqz, "prune_quantized_kernels", lambda p, q: p)
    cmc_j, map_j = jax_inference_main(flags + ["--ckpt", ckpt])
    if "--int8" in extra:
        assert calls["qconv"] > 0 and calls["qblock"] > 0
    cmc_t, map_t = inference_main(flags + ["--ckpt", npz], device="cpu")
    assert cmc_t.shape == (50,)
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6, (map_t, map_j)


@pytest.mark.parametrize("extra", [["--artifact", "a.stablehlo"],
                                   ["--search_option", "ivf"],
                                   ["--attributes_mat", "attr.mat"],
                                   []])
def test_later_slice_flags_raise(tmp_path, extra):
    from reid_tpu_torch.cli import inference_main
    ckpt = [] if not extra else ["--ckpt", "x.npz"]
    with pytest.raises(SystemExit):
        inference_main(["--root", str(tmp_path), *ckpt, *extra],
                       device="cpu")


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
