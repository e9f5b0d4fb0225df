"""The transformers through the port's CLIs against the JAX package's, one
run each, as tests/test_torch_zoo_cli.py holds the other backbones:

  * `track_main --backbone vit`, in bf16 and with `--int8`, on
    test_torch_cli's 16-frame scene (--chunk 8, 8 detection slots) at
    64x32 crops, the smallest size both packages take (ViT's stem and
    16x16 patches make a token of 32x32 pixels: two tokens and the cls
    token), ViT-t at full width (dim 384, depth 6, 16 heads): both sides
    from one set of weights (the port's init through the bridge, which
    the JAX run's checkpoint restore hands it) and, under `--int8`, one
    QuantState (JAX's): the same (frame, id) rows with boxes within 0.02
    px, the zoo CLI tests' limits; the tracker's width from the probe
    forward, 384 + classes; neither K1 nor the fused SE block taken.
  * `inference_main --backbone vit` on test_torch_retrieval's
    Market-style tree at 80x40 (f32, re-ranking on; D = 384 + 6), the
    split test_inference_main_plr_osnet_matches_jax uses: CMC identical
    at every rank, mAP within 1e-6. The port reads the number of classes
    from the checkpoint's classifier, which the transformers name
    "mlp_head" (`flax_bridge.classifier_width`).

  * `track_main --backbone swin_v1` at 224x224, the smallest size the
    JAX package runs Swin at (the grid must halve three times into whole
    7x7 windows), Swin-T at full width, on the first 6 frames of that
    scene (`--max_frames 6`, --chunk 3, 4 detection slots: two embed
    calls of 12 crops, where the whole scene's 128 crops took 68 s): the
    same limits as vit's, in bf16 (JAX's CLI runs its width probe, one
    crop, op by op: `test_torch_zoo_cli.jit_eager_apply` jits it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_cli import read_mot, write_scene
from test_torch_quantize import force_jax_routes
from test_torch_retrieval import write_market_tree
from test_torch_train_data import two_torch_threads  # noqa: F401
from test_torch_zoo_cli import jit_eager_apply, skip_jax_init


def port_variables(backbone, num_classes, hw):
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables
    return flax_variables(build_model(backbone, num_classes=num_classes,
                                      device="cpu", input_hw=hw))


def track_matches_jax(tmp_path, monkeypatch, backbone, hw, int8,
                      width, extra=("--chunk", "8", "--max_dets", "8"),
                      min_rows=20):
    """`track_main` of both packages on test_torch_cli's scene at `hw`
    crops from one set of weights (and one QuantState under `int8`),
    `extra` flags setting the chunk and the slots."""
    import reid_tpu.utils as jutils
    import reid_tpu.utils.quantize as jqz
    import reid_tpu_torch.utils.quantize as tqz
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu_torch import cli
    from reid_tpu_torch.tracking import pipeline as tpipe
    from reid_tpu_torch.utils.flax_bridge import (quant_state_from_flax,
                                                  save_npz)

    v = port_variables(backbone, 16, hw)
    ckpt = str(tmp_path / "w.npz")
    save_npz(ckpt, v)
    monkeypatch.setattr(jutils, "restore_checkpoint",
                        lambda path, tpl: jax.tree_util.tree_map(
                            jnp.asarray, v))
    skip_jax_init(monkeypatch, backbone, v)
    jit_eager_apply(monkeypatch, backbone)
    fdir, det = write_scene(tmp_path)
    flags = ["--detections", det, "--frames_dir", fdir, *extra,
             "--crop_hw", str(hw[0]), str(hw[1]), "--num_classes", "16",
             "--backbone", backbone, "--ckpt", ckpt] + (
                 ["--int8"] if int8 else [])
    calls = force_jax_routes(monkeypatch)
    qstates = []
    jquantize = jqz.quantize

    def keep_qstate(*a, **kw):
        qstates.append(jquantize(*a, **kw))
        return qstates[-1]
    monkeypatch.setattr(jqz, "quantize", keep_qstate)
    out_j = str(tmp_path / "jax.txt")
    n_j = jax_track_main(flags + ["--save_txt", out_j])
    assert calls == {"qconv": 0, "qblock": 0}
    assert len(qstates) == int(int8)

    if int8:
        monkeypatch.setattr(tqz, "quantize",
                            lambda model, batches, select=None:
                            quant_state_from_flax(qstates[0], "cpu"))
    monkeypatch.setattr(tqz, "conv3x3_s8", None)
    monkeypatch.setattr(tqz, "se_basic_block_s8", None)
    widths = []
    init = tpipe.TrackingPipeline.__init__

    def spy(self, cfg, embed_fn, feat_dim, *a, **kw):
        widths.append(feat_dim)
        init(self, cfg, embed_fn, feat_dim, *a, **kw)
    monkeypatch.setattr(tpipe.TrackingPipeline, "__init__", spy)
    out_t = str(tmp_path / "torch.txt")
    n_t = cli.track_main(flags + ["--save_txt", out_t], device="cpu")
    assert widths == [width + 16]
    assert n_t == n_j > min_rows
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_track_main_vit_matches_jax(tmp_path, monkeypatch, int8):
    track_matches_jax(tmp_path, monkeypatch, "vit", (64, 32), int8, 384)


def test_track_main_swin_v1_matches_jax(tmp_path, monkeypatch):
    track_matches_jax(tmp_path, monkeypatch, "swin_v1", (224, 224), False,
                      96, ("--chunk", "3", "--max_dets", "4",
                               "--max_frames", "6"), min_rows=6)


def test_inference_main_vit_matches_jax(tmp_path_factory, tmp_path,
                                        monkeypatch):
    import reid_tpu.utils as jutils
    from reid_tpu.cli import inference_main as jax_inference_main
    from reid_tpu_torch.cli import inference
    from reid_tpu_torch.utils.flax_bridge import save_npz

    market = write_market_tree(str(tmp_path_factory.mktemp("m") / "m"))
    v = port_variables("vit", 6, (80, 40))
    skip_jax_init(monkeypatch, "vit", v)
    monkeypatch.setattr(jutils, "restore_checkpoint",
                        lambda path, state: state.replace(
                            params=jax.tree_util.tree_map(jnp.asarray,
                                                          v["params"]),
                            batch_stats=jax.tree_util.tree_map(
                                jnp.asarray, v["batch_stats"])))
    npz = str(tmp_path / "vit.npz")
    save_npz(npz, v)
    flags = ["--root", market, "--height", "80", "--width", "40", "--bs",
             "8", "--backbone", "vit", "--ckpt"]
    keep = {}
    cmc_j, map_j = jax_inference_main(flags + ["unused"])
    cmc_t, map_t = inference(flags + [npz], device="cpu", keep=keep)
    assert keep["qf"].shape[1] == 384 + 6
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6, (map_t, map_j)
