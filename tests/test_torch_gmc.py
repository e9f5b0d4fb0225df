"""Camera-motion compensation (GMC) of the port against the JAX package.

  * `chunk_affines_translation` on the same frames (a texture panned by
    whole and by fractional pixels): translation within 1e-3 px (the two
    FFTs round differently), the 2x2 part exact;
  * `estimate_affine` in both branches, OpenCV's and the NumPy fallback
    (forced in both modules): equal;
  * the chunked tracker for botsort (GMC on) given the same embed: ids and
    valid identical, tlwh within 1e-3 px, as test_torch_pipeline.py holds
    strongsort; and the pipeline's recorded affines in both `gmc_mode`s;
  * the whole slice: both `track_main`s with `--tracking_method botsort`
    on a panned scene, chunked and `--chunk 1`: the same (frame, id) rows,
    boxes within 0.02 px, as test_torch_cli.py holds strongsort.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.tracking import gmc as jgmc
from reid_tpu.tracking import pipeline as jp
from reid_tpu.tracking.methods import method_config as jmc
from reid_tpu.tracking.tracker import init_tracker_state
from reid_tpu_torch.tracking import gmc as tgmc
from reid_tpu_torch.tracking import pipeline as tp
from reid_tpu_torch.tracking.methods import method_config as tmc
from reid_tpu_torch.tracking.tracker import init_tracker_state as tinit

from test_torch_cli import ckpt, read_mot  # noqa: F401
from test_torch_pipeline import CROP, jax_embed, torch_embed
from test_torch_quantize import force_jax_routes
from test_torch_train_data import two_torch_threads  # noqa: F401


def shifted_texture(t_total, h, w, shift, seed=0):
    """Frames of a periodic noise texture moved by `shift` = (sx, sy) px a
    frame, by any fraction of a pixel (a phase ramp on its spectrum)."""
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(h)[:, None]
    kx = np.fft.fftfreq(w)[None, :]
    spec = np.fft.fft2(rng.uniform(0, 255, (3, h, w)))
    frames = [np.fft.ifft2(spec * np.exp(-2j * np.pi * t * (
        kx * shift[0] + ky * shift[1]))).real for t in range(t_total)]
    return np.clip(np.stack(frames).transpose(0, 2, 3, 1), 0, 255).astype(
        np.uint8)


def panned_scene(t_total=16, n_t=4, max_dets=8, h=120, w=160, pan=(2, -2),
                 seed=0):
    """A texture the camera pans by `pan` px a frame, with `n_t` coloured
    boxes carried by the pan plus their own motion; detections with jitter
    and dropout as in examples/_scenes.py."""
    rng = np.random.default_rng(seed)
    px, py = pan
    mh, mw = abs(py) * t_total, abs(px) * t_total
    bg = rng.integers(0, 256, (h + mh, w + mw, 3)).astype(np.uint8)
    oy, ox = (mh if py > 0 else 0), (mw if px > 0 else 0)
    colors = rng.integers(60, 250, (n_t, 3))
    starts = rng.uniform([0, 0], [w - 60, h - 90], (n_t, 2))
    vels = rng.uniform(-1.5, 1.5, (n_t, 2))
    frames = np.zeros((t_total, h, w, 3), np.uint8)
    tlwh = np.zeros((t_total, max_dets, 4), np.float32)
    conf = np.zeros((t_total, max_dets), np.float32)
    valid = np.zeros((t_total, max_dets), bool)
    for t in range(t_total):
        frame = bg[oy - py * t:oy - py * t + h, ox - px * t:ox - px * t + w]
        frame = frame.copy()
        j = 0
        for i in range(n_t):
            x = float(np.clip(starts[i, 0] + (vels[i, 0] + px) * t, 0, w - 40))
            y = float(np.clip(starts[i, 1] + (vels[i, 1] + py) * t, 0, h - 90))
            frame[int(y):int(y + 80), int(x):int(x + 32)] = colors[i]
            if rng.random() < 0.08:
                continue
            tlwh[t, j] = (x + rng.normal(0, 1), y + rng.normal(0, 1),
                          32 + rng.normal(0, 1), 80 + rng.normal(0, 1))
            conf[t, j] = 0.7 + 0.25 * rng.random()
            valid[t, j] = True
            j += 1
        frames[t] = frame
    return frames, tlwh, conf, valid


@pytest.mark.parametrize("shift,downscale", [((2, -4), 2), ((4, 2), 0),
                                             ((1.3, -0.7), 1),
                                             ((-2.6, 1.8), 3)])
def test_chunk_affines_match_jax(shift, downscale):
    frames = shifted_texture(6, 96, 160, shift)
    want = np.asarray(jgmc.chunk_affines_translation(
        jnp.asarray(frames[0]), jnp.asarray(frames[1:]), downscale))
    got = tgmc.chunk_affines_translation(
        torch.from_numpy(frames[0]), torch.from_numpy(frames[1:]),
        downscale).numpy()
    assert got.shape == want.shape == (5, 2, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :, :2], want[:, :, :2])
    np.testing.assert_allclose(got[:, :, 2], want[:, :, 2], atol=1e-3)
    # and it sees the pan: exactly when it moves by whole bins of the
    # downscaled plane, within a pixel on the full plane (a subsampled
    # fractional shift of white noise aliases: parity only)
    ds = downscale or 2
    err = np.abs(got[:, :, 2] - np.asarray(shift, np.float32)).max()
    if all(v % ds == 0 for v in shift):
        assert err <= 1e-3, err
    elif ds == 1:
        assert err <= 1.0, err


@pytest.mark.parametrize("cv2", [True, False])
def test_estimate_affine_matches_jax(monkeypatch, cv2):
    if cv2 and not (jgmc._HAS_CV2 and tgmc._HAS_CV2):
        pytest.skip("OpenCV is not installed")
    monkeypatch.setattr(jgmc, "_HAS_CV2", cv2)
    monkeypatch.setattr(tgmc, "_HAS_CV2", cv2)
    frames, *_ = panned_scene(t_total=4, h=160, w=240, pan=(4, -2))
    for a, b in ((frames[0], frames[1]), (frames[1], frames[3]),
                 (None, frames[0])):
        want = jgmc.estimate_affine(a, b)
        got = tgmc.estimate_affine(a, b)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if not cv2:  # whole pixels of the 2x downscaled plane
        np.testing.assert_array_equal(
            tgmc.estimate_affine(frames[0], frames[1])[:, 2], [4.0, -2.0])


def test_chunked_botsort_matches_jax():
    frames, tlwh, conf, valid = panned_scene(seed=4)
    kw = dict(max_tracks=16, max_dets=8, crop_hw=CROP)
    jrun = jp.make_chunked_tracker(jmc("botsort", **kw), jax_embed, CROP,
                                   chunk=8)
    trun = tp.make_chunked_tracker(tmc("botsort", **kw), torch_embed, CROP,
                                   chunk=8)
    assert trun.use_gmc
    js = init_tracker_state(16, 24)
    ts = tinit(16, 24, device="cpu")
    for s in range(0, 16, 8):
        sl = slice(s, s + 8)
        prev = None if s == 0 else frames[s - 1]
        js, jo = jrun({}, {}, js, jnp.asarray(frames[sl]),
                      jnp.asarray(tlwh[sl]), jnp.asarray(conf[sl]),
                      jnp.asarray(valid[sl]),
                      prev_frame=None if prev is None else jnp.asarray(prev))
        ts, to = trun(ts, torch.from_numpy(frames[sl]),
                      torch.from_numpy(tlwh[sl]), torch.from_numpy(conf[sl]),
                      torch.from_numpy(valid[sl]),
                      prev_frame=None if prev is None
                      else torch.from_numpy(prev))
        v = np.asarray(jo["valid"])
        np.testing.assert_array_equal(to["valid"].numpy(), v)
        np.testing.assert_array_equal(to["ids"].numpy(), np.asarray(jo["ids"]))
        np.testing.assert_allclose(to["tlwh"].numpy()[v],
                                   np.asarray(jo["tlwh"])[v], atol=1e-3)
    assert int(ts.next_id) > 3


@pytest.mark.parametrize("mode", ["device", "host"])
def test_pipeline_records_the_affines_it_applies(mode):
    frames, tlwh, conf, valid = panned_scene(t_total=10, seed=2)
    cfg = tmc("botsort", max_tracks=16, max_dets=8, crop_hw=CROP)
    pipe = tp.TrackingPipeline(cfg, torch_embed, 24, device="cpu",
                               gmc_mode=mode)
    pipe.run_sequence(frames, tlwh, conf, valid, chunk=4)
    got = np.stack(pipe.affines)
    assert got.shape == (10, 2, 3)
    if mode == "host":
        want = [tgmc.estimate_affine(frames[max(i - 1, 0)], frames[i])
                for i in range(10)]
    else:
        ft = torch.from_numpy(frames)
        want = [tgmc.chunk_affines_translation(
            ft[s - 1] if s else ft[0], ft[s:s + 4]).numpy()[:len(ft[s:s + 4])]
            for s in range(0, 10, 4)]
    np.testing.assert_array_equal(got, np.concatenate(
        [np.reshape(a, (-1, 2, 3)) for a in want]))
    # the step path warps by estimate_affine, frame by frame
    step = tp.TrackingPipeline(cfg, torch_embed, 24, device="cpu")
    for i in range(3):
        step.step(i + 1, frames[i], tlwh[i], conf[i], valid[i])
    np.testing.assert_array_equal(np.stack(step.affines), np.stack(
        [tgmc.estimate_affine(None if i == 0 else frames[i - 1], frames[i])
         for i in range(3)]))
    with pytest.raises(ValueError):
        tp.TrackingPipeline(cfg, torch_embed, 24, device="cpu",
                            gmc_mode="cuda")


def write_panned_scene(root):
    frames, tlwh, conf, valid = panned_scene(seed=1)
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


@pytest.mark.parametrize("chunk", ["8", "1"])
def test_track_main_botsort_matches_jax(tmp_path, monkeypatch, chunk,
                                        ckpt):
    """botsort's default turns GMC on: chunked with the device estimator
    on both sides, `--chunk 1` with `estimate_affine` per frame. The port
    reads the flax init of JAX's `track_main` (test_torch_cli's `ckpt`,
    one for the module)."""
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu_torch.cli import track_main

    fdir, det = write_panned_scene(tmp_path)
    flags = ["--detections", det, "--frames_dir", fdir, "--int8",
             "--chunk", chunk, "--crop_hw", "64", "32", "--num_classes",
             "16", "--max_dets", "8", "--tracking_method", "botsort"]
    force_jax_routes(monkeypatch)
    from test_torch_zoo_cli import jit_eager_apply
    jit_eager_apply(monkeypatch, "seres18")
    out_j = str(tmp_path / "jax.txt")
    n_j = jax_track_main(flags + ["--save_txt", out_j])
    out_t = str(tmp_path / "torch.txt")
    n_t = track_main(flags + ["--save_txt", out_t, "--ckpt", ckpt],
                     device="cpu")
    assert n_t == n_j > 20
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)
