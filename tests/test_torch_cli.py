"""The slice as a whole: the port's `track_main` against the JAX package's
`track_main` on the same scene, frames and flax init, with `--int8` (the
JAX kernel routes forced on through their references) and without it
(the default bf16 embed). Under `--int8` each side calibrates on its own
(per-layer scales agree to ~1e-2); in bf16 the two round each convolution
in their own order (test_torch_models.py). So the embeds differ slightly;
the MOT files must still hold the same (frame, id) rows with boxes within
0.02 px."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from _scenes import build_mot_scene  # noqa: E402

from test_torch_quantize import force_jax_routes  # noqa: E402


def write_scene(root):
    frames, tlwh, conf, valid, _ = build_mot_scene(
        t_total=16, n_t=4, max_dets=8, h=120, w=160)
    fdir = root / "frames"
    fdir.mkdir()
    rows = []
    for t in range(frames.shape[0]):
        np.save(fdir / f"{t + 1:06d}.npy", frames[t])
        for j in np.flatnonzero(valid[t]):
            x, y, w, h = tlwh[t, j]
            rows.append(f"{t + 1},-1,{x:.3f},{y:.3f},{w:.3f},{h:.3f},"
                        f"{conf[t, j]:.4f}")
    det = root / "det.txt"
    det.write_text("\n".join(rows) + "\n")
    return str(fdir), str(det)


def read_mot(path):
    rows = np.loadtxt(path, delimiter=",", ndmin=2)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_track_main_matches_jax(tmp_path, monkeypatch, int8):
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu.models import build_model as jbuild
    from reid_tpu_torch.cli import track_main
    from reid_tpu_torch.utils.flax_bridge import save_npz

    fdir, det = write_scene(tmp_path)
    flags = ["--detections", det, "--frames_dir", fdir, "--chunk", "8",
             "--crop_hw", "64", "32", "--num_classes", "16", "--max_dets",
             "8"] + (["--int8"] if int8 else [])
    # the flax init of reid_tpu.cli.track_main, saved for the port's --ckpt
    model = jbuild("seres18", num_classes=16, dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3), jnp.bfloat16))
    ckpt = str(tmp_path / "init.npz")
    save_npz(ckpt, jax.tree_util.tree_map(np.asarray, variables))

    calls = force_jax_routes(monkeypatch)
    out_j = str(tmp_path / "jax.txt")
    n_j = jax_track_main(flags + ["--save_txt", out_j])
    assert (calls["qconv"] > 0 and calls["qblock"] > 0) == int8

    out_t = str(tmp_path / "torch.txt")
    n_t = track_main(flags + ["--save_txt", out_t, "--ckpt", ckpt],
                     device="cpu")
    assert n_t == n_j > 20
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)


@pytest.mark.parametrize("extra", [["--gt", "gt.txt"],
                                   ["--save_vid", "out.avi"]])
def test_later_slice_flags_raise(tmp_path, extra):
    from reid_tpu_torch.cli import track_main
    det = tmp_path / "det.txt"
    det.write_text("1,-1,10,10,20,40,0.9\n")
    with pytest.raises(SystemExit):
        track_main(["--detections", str(det), *extra], device="cpu")


def test_step_path_runs_on_cpu(tmp_path):
    """--chunk 1 (the per-frame step path) and botsort with --gmc off."""
    from reid_tpu_torch.cli import track_main
    fdir, det = write_scene(tmp_path)
    n = track_main(["--detections", det, "--frames_dir", fdir,
                    "--crop_hw", "64", "32", "--num_classes", "8",
                    "--max_dets", "8", "--tracking_method", "botsort",
                    "--gmc", "off", "--save_txt", str(tmp_path / "o.txt")],
                   device="cpu")
    assert n > 20


def test_track_restores_tf32_flags(tmp_path, monkeypatch):
    """`track` runs in full f32 and gives the caller's TF32 settings back."""
    import torch
    from reid_tpu_torch.cli import track
    seen = []
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr("reid_tpu_torch.cli._track", lambda args, device: (
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))))
    det = tmp_path / "det.txt"
    det.write_text("1,-1,10,10,20,40,0.9\n")
    track(["--detections", str(det)], device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
