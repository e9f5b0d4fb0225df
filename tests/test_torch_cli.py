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
from test_torch_train_data import two_torch_threads  # noqa: E402,F401


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


def flax_init_npz(root):
    """The flax init of reid_tpu.cli.track_main (SERes18, 16 classes, 64x32
    crops), saved for the port's --ckpt."""
    from reid_tpu.models import build_model as jbuild
    from reid_tpu_torch.utils.flax_bridge import save_npz

    model = jbuild("seres18", num_classes=16, dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3), jnp.bfloat16))
    ckpt = str(root / "init.npz")
    save_npz(ckpt, jax.tree_util.tree_map(np.asarray, variables))
    return ckpt


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`flax_init_npz` once for the module's tests."""
    return flax_init_npz(tmp_path_factory.mktemp("init"))


@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory, ckpt):
    """Both packages' `track_main --gt` on the scene with the bf16 embed
    (--chunk 8), run once for test_track_main_matches_jax[bf16] and
    test_gt_metrics_match_jax: (metrics and MOT file) of JAX, then of the
    port, and the JAX run's calls of the int8 kernels' routes."""
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu_torch.cli import track_main
    from test_torch_zoo_cli import jit_eager_apply

    root = tmp_path_factory.mktemp("bf16")
    fdir, det = write_scene(root)
    gt = write_gt(root)
    flags = ["--detections", det, "--frames_dir", fdir, "--chunk", "8",
             "--crop_hw", "64", "32", "--num_classes", "16", "--max_dets",
             "8", "--gt", gt, "--benchmark", "MOT17"]
    out_j, out_t = str(root / "jax.txt"), str(root / "torch.txt")
    with pytest.MonkeyPatch.context() as mp:
        calls = force_jax_routes(mp)
        jit_eager_apply(mp, "seres18")
        want = jax_track_main(flags + ["--save_txt", out_j])
    got = track_main(flags + ["--save_txt", out_t, "--ckpt", ckpt],
                     device="cpu")
    return (want, out_j), (got, out_t), dict(calls)


def read_mot(path):
    rows = np.loadtxt(path, delimiter=",", ndmin=2)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_track_main_matches_jax(tmp_path, monkeypatch, ckpt, bf16_runs,
                                int8):
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu_torch.cli import track_main
    from test_torch_zoo_cli import jit_eager_apply

    if int8:
        fdir, det = write_scene(tmp_path)
        flags = ["--detections", det, "--frames_dir", fdir, "--chunk", "8",
                 "--crop_hw", "64", "32", "--num_classes", "16",
                 "--max_dets", "8", "--int8"]
        calls = force_jax_routes(monkeypatch)
        jit_eager_apply(monkeypatch, "seres18")
        out_j = str(tmp_path / "jax.txt")
        n_j = jax_track_main(flags + ["--save_txt", out_j])
        out_t = str(tmp_path / "torch.txt")
        n_t = track_main(flags + ["--save_txt", out_t, "--ckpt", ckpt],
                         device="cpu")
    else:
        # the bf16 run, with --gt, which leaves the MOT rows as they are
        (_, out_j), (_, out_t), calls = bf16_runs
        n_j, n_t = len(read_mot(out_j)), len(read_mot(out_t))
    assert (calls["qconv"] > 0 and calls["qblock"] > 0) == int8
    assert n_t == n_j > 20
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)


def write_gt(root):
    """The scene's true boxes as a 9-column MOT16 gt.txt (pedestrians,
    all scored)."""
    *_, gt = build_mot_scene(t_total=16, n_t=4, max_dets=8, h=120, w=160)
    rows = [f"{t + 1},{i + 1},{x:.2f},{y:.2f},{w:.2f},{h:.2f},1,1,1.0"
            for t, (boxes, ids) in sorted(gt.items())
            for (x, y, w, h), i in zip(boxes, ids)]
    path = root / "gt.txt"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_gt_metrics_match_jax(bf16_runs):
    """`--gt`: `track_main` returns the CLEAR / Identity / HOTA dict, equal
    to the JAX package's on the same scene and flax init (bf16 embed,
    --chunk 8: the program of test_track_main_matches_jax[bf16])."""
    (want, _), (got, _), _ = bf16_runs
    assert isinstance(got, dict) and got.keys() == want.keys()
    assert got["MOTA"] > 50 and got["num_gt"] > 40
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def yolo_pt(root):
    """yolov5p weights that detect something on the scene, as a published
    (ultralytics-named) state_dict .pt: the JAX CLI's flax init with the
    BN scales at 1.3 U(0.5, 1.5) and moved statistics, the objectness
    biases at 1. Returns the path and the JAX package's variables."""
    import re

    import torch
    from reid_tpu.models.yolo import build_yolo
    from reid_tpu_torch.models import yolo as ty
    from reid_tpu_torch.utils.flax_bridge import load_flax_variables

    rng = np.random.default_rng(0)
    model = build_yolo("yolov5p", 1, jnp.bfloat16)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: model.init(k, x, train=False))(
            jax.random.PRNGKey(1), jnp.zeros((1, 96, 160, 3))))

    def walk(tree, path=()):
        for k, x in tree.items():
            if isinstance(x, dict):
                walk(x, path + (k,))
            elif k == "scale":
                tree[k] = (1.3 * rng.uniform(0.5, 1.5, x.shape)).astype(
                    np.float32)
            elif k == "mean":
                tree[k] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.0, x.shape).astype(np.float32)
            elif path[0].startswith("det_m") and k == "bias":
                tree[k] = x.reshape(3, 6).copy()
                tree[k][:, 4] = 1.0
                tree[k] = tree[k].reshape(-1)
    walk(v)
    tm = ty.build_yolo("yolov5p", dtype=torch.float32, device="cpu")
    load_flax_variables(tm, v)
    sd = {}
    for name, t in tm.state_dict().items():
        k = re.sub(r"^det_m(\d+)", r"model.24.m.\1", name)
        k = re.sub(r"^l(\d+)\.", r"model.\1.", k)
        sd[re.sub(r"\.m(\d+)\.", r".m.\1.", k)] = t
    path = root / "yolov5p.pt"
    torch.save(sd, path)
    return str(path), model, v


def centernet_ckpts(root):
    """The JAX CLI's CenterNetLite init (base 8 at 64x96, PRNGKey(1)) with
    the size head's bias at a box of 32x80 px on 120x160 frames, as an
    orbax checkpoint for the JAX CLI and its `.npz` for the port."""
    from reid_tpu.models.detector import CenterNetLite
    from reid_tpu.utils import save_checkpoint
    from reid_tpu_torch.utils.flax_bridge import save_npz

    model = CenterNetLite(base=8)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: model.init(k, x, train=True))(
            jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 3))))
    v["params"]["wh"]["bias"] = np.asarray([4.8, 10.7], np.float32)
    save_npz(str(root / "centernet.npz"), v)
    return save_checkpoint(str(root / "centernet_orbax"), v), str(
        root / "centernet.npz")


# frames of the static scene: 8 calibrate the int8 detector, the rest
# confirm tracks
N_STATIC = 10


def write_static_scene(root, n_frames=16):
    """Three bright 32x80 boxes sliding 1 px a frame over a black 120x160
    background: random detector weights give boxes that stay put from
    frame to frame, so the tracker confirms tracks."""
    fdir = root / "static"
    fdir.mkdir()
    colors = np.random.default_rng(0).integers(120, 255, (3, 3))
    for t in range(n_frames):
        frame = np.zeros((120, 160, 3), np.uint8)
        for i, (x0, vx) in enumerate(((20, 1), (70, -1), (110, 1))):
            frame[20:100, x0 + vx * t:x0 + vx * t + 32] = colors[i]
        np.save(fdir / f"{t + 1:06d}.npy", frame)
    return str(fdir)


@pytest.mark.parametrize("detector", ["yolov5_int8", "centernet"])
def test_builtin_detector_matches_jax(tmp_path, capsys, monkeypatch, ckpt,
                                      detector):
    """No --detections: the built-in detector on every frame (the step
    path; --chunk 8 falls back to it, as in the JAX package), then the
    tracker. YOLOv5 (yolov5p from a published-layout --det_torch, its
    trunk in int8 calibrated on the first 8 source frames) or
    CenterNetLite (base 8, f32, through --det_ckpt). On a static scene
    (`write_static_scene`), the same (frame, id) rows as the JAX package's
    CLI, boxes within 0.02 px; with --save_vid one annotated image a
    frame.

    Under --int8 the port's detector takes the QuantState that the JAX
    package's `quantize_yolo` computes from the frames the port's CLI
    hands its own: with random weights the int8 trunk is chaotic, and the
    two calibrations differ by a bf16 ulp of one layer's absmax in 2 of
    57 layers (each side sums its bf16 convolutions in its own order),
    enough to move detections. test_torch_yolo.py holds the calibrations
    against each other and the int8 detectors under one QuantState."""
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu_torch.cli import track_main
    from test_torch_zoo_cli import jit_eager_apply

    fdir = write_static_scene(tmp_path, N_STATIC)
    flags = ["--source", fdir, "--chunk", "8", "--crop_hw", "64", "32",
             "--num_classes", "16", "--max_dets", "8"]
    jax_only = []
    if detector == "yolov5_int8":
        from reid_tpu.models import yolo as jy
        from reid_tpu_torch.models import yolo as ty
        from reid_tpu_torch.utils.flax_bridge import quant_state_from_flax

        pt, jmodel, jvars = yolo_pt(tmp_path)
        calls, port_calibration = [], ty.quantize_yolo

        def jax_calibration(model, frames, det_hw):
            calls.append(np.asarray(frames).shape)
            port_calibration(model, frames, det_hw)         # the port's runs
            return quant_state_from_flax(
                jy.quantize_yolo(jmodel, jvars, frames, det_hw), "cpu")
        monkeypatch.setattr(ty, "quantize_yolo", jax_calibration)
        flags += ["--detector", "yolov5", "--yolo_variant", "yolov5p",
                  "--det_size", "96", "160", "--int8", "--conf_thres",
                  "0.3", "--det_torch", pt]
        port_only = ["--save_vid", str(tmp_path / "vid")]
    else:
        orbax, npz = centernet_ckpts(tmp_path)
        flags += ["--detector", "centernet", "--det_base", "8",
                  "--det_size", "64", "96", "--conf_thres", "0.05"]
        jax_only, port_only = ["--det_ckpt", orbax], ["--det_ckpt", npz]
    out_j, out_t = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    jit_eager_apply(monkeypatch, "seres18")
    n_j = jax_track_main(flags + jax_only + ["--save_txt", out_j])
    capsys.readouterr()
    n_t = track_main(flags + port_only + ["--save_txt", out_t, "--ckpt",
                                          ckpt], device="cpu")
    assert "falling back to the per-frame path" in capsys.readouterr().out
    assert n_t == n_j > 10
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)
    if detector == "yolov5_int8":
        assert calls == [(8, 120, 160, 3)]
        assert sorted(os.listdir(tmp_path / "vid")) == [
            f"{i:06d}.jpg" for i in range(1, N_STATIC + 1)]


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
