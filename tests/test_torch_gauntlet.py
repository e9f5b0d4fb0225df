"""The port's gauntlet (`reid_tpu_torch.gauntlet`): its copy of the scene
renderer byte-equal to examples/gauntlet.py at a cut size, its bands equal
to scripts/mot_gauntlet.py's, and a cut scene (16 frames, 10 pedestrians,
crops of 64x32, 16 classes, chunks of 8 frames and 16 detection slots)
run through the port's and the JAX package's `track_main --gt` with the
gauntlet's other flags and the same flax init: equal metrics for two
methods (botsort with its camera-motion compensation)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import gauntlet as ref  # noqa: E402

from reid_tpu_torch import gauntlet  # noqa: E402
from test_torch_train_data import two_torch_threads  # noqa: E402,F401


def test_renderer_byte_equal(tmp_path):
    for n in ("port", "ref"):
        mod = gauntlet if n == "port" else ref
        mod.write_gauntlet(str(tmp_path / n), t_total=6, n_ped=8, seed=3)
    for rel in ["gt.txt", "det.txt"] + [
            os.path.join("img1", f) for f in sorted(os.listdir(
                tmp_path / "ref" / "img1"))]:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "ref" / rel).read_bytes(), rel
    fp, gp, dp = gauntlet.build_gauntlet(t_total=4, n_ped=6, seed=1)
    fr, gr, dr = ref.build_gauntlet(t_total=4, n_ped=6, seed=1)
    assert np.array_equal(fp, fr) and gp == gr and dp == dr


def test_bands_and_flags_equal_script():
    import mot_gauntlet
    assert gauntlet.CHECK_BANDS == mot_gauntlet.CHECK_BANDS
    assert gauntlet.METHODS == mot_gauntlet.METHODS
    bad = gauntlet.band_failures({"ocsort": {"MOTA": 56.0, "IDF1": 40.0,
                                             "HOTA": 45.0}})
    assert bad == ["ocsort IDF1=40.0 outside [47.7, 57.7]"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from reid_tpu.models import build_model as jbuild
    from reid_tpu_torch.utils.flax_bridge import save_npz

    root = tmp_path_factory.mktemp("gauntlet")
    img, gt, det = gauntlet.write_gauntlet(str(root), t_total=16, n_ped=10)
    model = jbuild("seres18", num_classes=16, dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3), jnp.bfloat16))
    ckpt = str(root / "init.npz")
    save_npz(ckpt, jax.tree_util.tree_map(np.asarray, variables))
    return str(root), img, gt, det, ckpt


@pytest.mark.parametrize("method", ["strongsort", "botsort"])
def test_cut_scene_metrics_equal_jax(scene, method, monkeypatch):
    from reid_tpu.cli import track_main as jax_track_main
    from test_torch_zoo_cli import jit_eager_apply

    jit_eager_apply(monkeypatch, "seres18")

    root, img, gt, det, ckpt = scene
    # the cut: later flags override the gauntlet's --chunk and --max_dets
    small = ["--crop_hw", "64", "32", "--num_classes", "16", "--chunk", "8",
             "--max_dets", "16"]
    out = os.path.join(root, "out")
    os.makedirs(out, exist_ok=True)
    got = gauntlet.run_method(method, img, gt, det, out, extra_args=[
        *small, "--ckpt", ckpt], device="cpu")
    want = jax_track_main(
        ["--source", img, "--detections", det, "--tracking_method", method,
         "--save_txt", os.path.join(out, f"{method}_jax.txt"), "--gt", gt,
         *gauntlet.RUN_FLAGS, *small])
    assert got["num_hyp"] > 50
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
