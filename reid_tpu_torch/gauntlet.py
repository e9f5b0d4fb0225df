"""Hard MOT gauntlet for the port: a distractor-rich crowd scene driven
end to end through `reid_tpu_torch.cli.track_main --gt`.

The port's counterpart of `scripts/mot_gauntlet.py`. The scene renderer
(`build_gauntlet`, `write_gauntlet`) is a copy of `examples/gauntlet.py`
(NumPy only; that file lies outside the package), unchanged: ~56 textured
pedestrians at crowd density with mutual occlusion and two foreground
pillars, a sinusoidal camera pan, distractor classes that are drawn,
detected and removed only by `preprocess_mot`'s distractor matching,
zero-marked pedestrian rows, a crowd region (class 13) and detection noise
scaled by visibility, written in MOT16 layout. tests/test_torch_gauntlet.py
holds the copy byte-equal to the original.

    python -m reid_tpu_torch.gauntlet                  # 5 methods, a table
    python -m reid_tpu_torch.gauntlet strongsort       # one method
    python -m reid_tpu_torch.gauntlet --check          # exit 1 off a band
    python -m reid_tpu_torch.gauntlet --dir scene/     # keep the scene

Every method runs `track_main` with `--chunk 16 --conf_thres 0.3
--max_dets 64` on the card (`--device cpu` for the CPU). Without `--dir`
the scene is rendered into a temporary directory that is removed
afterwards.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

METHODS = ["strongsort", "deepocsort", "ocsort", "bytetrack", "botsort"]

# pinned per-method bands (MOTA lo/hi, IDF1 lo/hi, HOTA lo/hi), +-4/5/4
# points around the measured 2026-08-19 on-chip run of the JAX package
# (EVAL.md "Hard MOT gauntlet"): strongsort 53.93/49.61/40.34, deepocsort
# 57.79/52.35/45.10, ocsort 56.10/52.71/44.98, bytetrack 50.69/48.02/41.79,
# botsort 58.51/57.23/48.04. Wide enough for precision jitter (int8/
# fastcrop/ds2 deltas measured <= 0.74 MOTA on this scene), tight enough to
# trip on method-logic regressions of a few points. Copied from
# scripts/mot_gauntlet.py; that run's SERes18 weights were a random flax
# init, the port's are a random init of its own (seed 0).
CHECK_BANDS = {
    "strongsort": ((49.9, 57.9), (44.6, 54.6), (36.3, 44.3)),
    "deepocsort": ((53.8, 61.8), (47.4, 57.4), (41.1, 49.1)),
    "ocsort":     ((52.1, 60.1), (47.7, 57.7), (41.0, 49.0)),
    "bytetrack":  ((46.7, 54.7), (43.0, 53.0), (37.8, 45.8)),
    "botsort":    ((54.5, 62.5), (52.2, 62.2), (44.0, 52.0)),
}
RUN_FLAGS = ("--chunk", "16", "--conf_thres", "0.3", "--max_dets", "64")

WORLD_W = 1280
FRAME_H, FRAME_W = 480, 640

MOT_PEDESTRIAN = 1
DISTRACTOR_CLASSES = (7, 8, 12)   # static_person, distractor, reflection
CROWD_CLASS = 13


def _texture(rng, h, w, c1, c2, period, vertical):
    """Striped two-color texture — appearance-discriminative per identity."""
    tex = np.empty((h, w, 3), np.uint8)
    idx = (np.arange(h)[:, None] if vertical else np.arange(w)[None, :])
    stripe = ((idx // max(period, 2)) % 2).astype(bool)
    stripe = np.broadcast_to(stripe, (h, w))
    tex[stripe] = c1
    tex[~stripe] = c2
    return tex


def build_gauntlet(t_total=300, n_ped=56, n_distractor=8, seed=0):
    """Build the scene; returns (frames, gt_rows, det_rows).

    frames: (T, 480, 640, 3) uint8.
    gt_rows / det_rows: lists of MOT16-format tuples
      gt:  (frame, id, x, y, w, h, flag, cls, visibility)
      det: (frame, -1, x, y, w, h, conf)
    """
    rng = np.random.default_rng(seed)

    # ---- pedestrians (world coords)
    heights = rng.uniform(52, 140, n_ped)
    widths = heights * 0.41
    px = rng.uniform(0, WORLD_W - widths)
    py = rng.uniform(0, FRAME_H - heights)
    vx = rng.normal(0, 2.2, n_ped)
    vy = rng.normal(0, 0.7, n_ped)
    still = rng.random(n_ped) < 0.15           # some stand (long pillar
    vx[still] *= 0.1                            # occlusions need slow prey)
    vy[still] *= 0.1
    wob_a = rng.uniform(0, 18, n_ped)           # sinusoidal wobble
    wob_f = rng.uniform(0.01, 0.05, n_ped)
    wob_p = rng.uniform(0, 2 * np.pi, n_ped)
    colors = rng.integers(40, 255, (n_ped, 2, 3))
    periods = rng.integers(4, 14, n_ped)
    zero_marked = rng.permutation(n_ped)[:4]    # ignored-but-present peds

    # ---- distractors: static person-shaped textured boxes
    d_h = rng.uniform(60, 120, n_distractor)
    d_w = d_h * 0.41
    d_x = rng.uniform(0, WORLD_W - d_w)
    d_y = rng.uniform(0, FRAME_H - d_h)
    d_cls = rng.choice(DISTRACTOR_CLASSES, n_distractor)
    d_colors = rng.integers(40, 255, (n_distractor, 2, 3))
    d_periods = rng.integers(4, 14, n_distractor)

    # ---- crowd region (world-anchored): dense blob clutter
    crowd = (880.0, 260.0, 260.0, 180.0)        # x, y, w, h in world
    n_blob = 60
    blob_x = crowd[0] + rng.uniform(0, crowd[2], n_blob)
    blob_y = crowd[1] + rng.uniform(0, crowd[3], n_blob)
    blob_c = rng.integers(60, 220, (n_blob, 3))

    # ---- pillars (foreground, world-anchored)
    pillars = [(330.0, 64.0), (820.0, 72.0)]    # (x, width), full height

    frames = np.zeros((t_total, FRAME_H, FRAME_W, 3), np.uint8)
    gt_rows, det_rows = [], []

    for t in range(t_total):
        cam_x = 320.0 + 280.0 * np.sin(2 * np.pi * t / 240.0)
        world = rng.integers(0, 46, (FRAME_H, WORLD_W, 3)).astype(np.uint8)
        idbuf = np.full((FRAME_H, WORLD_W), -1, np.int32)

        # crowd clutter (background layer)
        for i in range(n_blob):
            bx = int(blob_x[i] + 3 * np.sin(0.1 * t + i))
            by = int(blob_y[i])
            world[by:by + 14, bx:bx + 7] = blob_c[i]

        # positions this frame
        x = np.clip(px + vx * t + wob_a * np.sin(wob_f * t + wob_p),
                    0, WORLD_W - widths)
        y = np.clip(py + vy * t, 0, FRAME_H - heights)

        # draw far-to-near (depth = bottom edge); nearer overdraws
        order = np.argsort(y + heights)
        for i in order:
            x0, y0 = int(x[i]), int(y[i])
            w0, h0 = int(widths[i]), int(heights[i])
            world[y0:y0 + h0, x0:x0 + w0] = _texture(
                rng, h0, w0, colors[i, 0], colors[i, 1], periods[i],
                bool(i % 2))
            idbuf[y0:y0 + h0, x0:x0 + w0] = i
        for j in range(n_distractor):
            x0, y0 = int(d_x[j]), int(d_y[j])
            w0, h0 = int(d_w[j]), int(d_h[j])
            world[y0:y0 + h0, x0:x0 + w0] = _texture(
                rng, h0, w0, d_colors[j, 0], d_colors[j, 1], d_periods[j],
                True)
            idbuf[y0:y0 + h0, x0:x0 + w0] = 1000 + j
        for (plx, plw) in pillars:                      # foreground
            world[:, int(plx):int(plx + plw)] = (70, 62, 58)
            idbuf[:, int(plx):int(plx + plw)] = -2

        ci = int(round(cam_x))
        frames[t] = world[:, ci:ci + FRAME_W]
        idwin = idbuf[:, ci:ci + FRAME_W]

        # ---- gt + detections (frame coords)
        fidx = t + 1
        for i in range(n_ped):
            fx = x[i] - ci
            if fx + widths[i] < 2 or fx > FRAME_W - 2:
                continue                                 # fully off-frame
            area = widths[i] * heights[i]
            vis_px = float(np.sum(idwin == i))
            vis = vis_px / max(area, 1.0)
            flag = 0 if i in zero_marked else 1
            gt_rows.append((fidx, i + 1, fx, y[i], widths[i], heights[i],
                            flag, MOT_PEDESTRIAN, round(vis, 3)))
            # detection: probability ramps with visibility
            p_det = np.interp(vis, [0.08, 0.5], [0.0, 0.95])
            if rng.random() < p_det:
                jit = rng.normal(0, 0.05, 4)
                bw = widths[i] * (1 + jit[2])
                bh = heights[i] * (1 + jit[3])
                conf = float(np.clip(0.45 + 0.5 * vis
                                     + rng.normal(0, 0.08), 0.15, 1.0))
                det_rows.append((fidx, -1,
                                 fx + jit[0] * widths[i],
                                 y[i] + jit[1] * heights[i], bw, bh, conf))
        for j in range(n_distractor):
            fx = d_x[j] - ci
            if fx + d_w[j] < 2 or fx > FRAME_W - 2:
                continue
            gt_rows.append((fidx, 500 + j, fx, d_y[j], d_w[j], d_h[j],
                            1, int(d_cls[j]), 1.0))
            if rng.random() < 0.9:                      # they look real
                jit = rng.normal(0, 0.03, 2)
                det_rows.append((fidx, -1, fx + jit[0] * d_w[j],
                                 d_y[j] + jit[1] * d_h[j], d_w[j], d_h[j],
                                 float(np.clip(0.75 + rng.normal(0, 0.1),
                                               0.2, 1.0))))
        # crowd region gt row (class 13 — excluded at gt load)
        cfx = crowd[0] - ci
        if cfx + crowd[2] > 2 and cfx < FRAME_W - 2:
            gt_rows.append((fidx, 900, cfx, crowd[1], crowd[2], crowd[3],
                            1, CROWD_CLASS, 1.0))
            for _ in range(rng.poisson(1.2)):           # crowd FPs
                det_rows.append((fidx, -1,
                                 cfx + rng.uniform(0, crowd[2] - 20),
                                 crowd[1] + rng.uniform(0, crowd[3] - 40),
                                 rng.uniform(14, 26), rng.uniform(34, 60),
                                 float(rng.uniform(0.3, 0.6))))
        # random false positives
        for _ in range(rng.poisson(2.0)):
            det_rows.append((fidx, -1, rng.uniform(0, FRAME_W - 40),
                             rng.uniform(0, FRAME_H - 90),
                             rng.uniform(20, 40), rng.uniform(50, 100),
                             float(rng.uniform(0.2, 0.75))))
        # merged box for strongly overlapping pedestrian pairs
        fr_x = x - ci
        for i in range(n_ped):
            for k in range(i + 1, n_ped):
                ix0 = max(fr_x[i], fr_x[k])
                ix1 = min(fr_x[i] + widths[i], fr_x[k] + widths[k])
                iy0 = max(y[i], y[k])
                iy1 = min(y[i] + heights[i], y[k] + heights[k])
                inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
                union = (widths[i] * heights[i] + widths[k] * heights[k]
                         - inter)
                if inter / max(union, 1.0) > 0.45 and rng.random() < 0.3:
                    ux0 = min(fr_x[i], fr_x[k])
                    uy0 = min(y[i], y[k])
                    uw = max(fr_x[i] + widths[i],
                             fr_x[k] + widths[k]) - ux0
                    uh = max(y[i] + heights[i], y[k] + heights[k]) - uy0
                    if ux0 + uw > 2 and ux0 < FRAME_W - 2:
                        det_rows.append((fidx, -1, ux0, uy0, uw, uh,
                                         float(rng.uniform(0.5, 0.8))))
    return frames, gt_rows, det_rows


def write_gauntlet(out_dir: str, t_total=300, n_ped=56, seed=0):
    """Render to disk in MOT16 layout: img1/*.png (written as raw .npy for
    zero-dependency IO — sources.iter_frames reads .npy frames), gt.txt
    (9-column), det.txt. Returns (frames_dir, gt_path, det_path)."""
    frames, gt_rows, det_rows = build_gauntlet(t_total=t_total, n_ped=n_ped,
                                               seed=seed)
    img_dir = os.path.join(out_dir, "img1")
    os.makedirs(img_dir, exist_ok=True)
    for t in range(frames.shape[0]):
        np.save(os.path.join(img_dir, f"{t + 1:06d}.npy"), frames[t])
    gt_path = os.path.join(out_dir, "gt.txt")
    with open(gt_path, "w") as f:
        for r in gt_rows:
            f.write(f"{r[0]},{r[1]},{r[2]:.2f},{r[3]:.2f},{r[4]:.2f},"
                    f"{r[5]:.2f},{r[6]},{r[7]},{r[8]}\n")
    det_path = os.path.join(out_dir, "det.txt")
    with open(det_path, "w") as f:
        for r in det_rows:
            f.write(f"{r[0]},{r[1]},{r[2]:.2f},{r[3]:.2f},{r[4]:.2f},"
                    f"{r[5]:.2f},{r[6]:.3f}\n")
    return img_dir, gt_path, det_path


def run_method(method, img_dir, gt, det, out_dir, extra_args=(),
               device="cuda"):
    """One method through `track_main --gt`; returns its metrics with the
    wall seconds the run took."""
    from .cli import track_main

    out_txt = os.path.join(out_dir, f"{method}.txt")
    argv = ["--source", img_dir, "--detections", det,
            "--tracking_method", method, "--save_txt", out_txt, "--gt", gt,
            *RUN_FLAGS, *extra_args]
    t0 = time.perf_counter()
    m = track_main(argv, device=device)
    m["seconds"] = time.perf_counter() - t0
    return m


def band_failures(results):
    """Each metric off its band, as 'method KEY=value outside [lo, hi]'."""
    bad = []
    for method, m in results.items():
        bands = CHECK_BANDS.get(method)
        if bands is None:
            continue
        for key, (lo, hi) in zip(("MOTA", "IDF1", "HOTA"), bands):
            v = m.get(key)
            if v is None or not lo <= v <= hi:
                bad.append(f"{method} {key}={v} outside [{lo}, {hi}]")
    return bad


def run(methods=None, scene_dir="", device="cuda"):
    """Render the scene (into `scene_dir`, else a temporary directory) and
    run each method; returns {method: metrics}."""
    methods = methods or METHODS
    with tempfile.TemporaryDirectory() as tmp:
        root = scene_dir or tmp
        gt = os.path.join(root, "gt.txt")
        if not os.path.exists(gt):
            write_gauntlet(root)
        img_dir, det = os.path.join(root, "img1"), os.path.join(root,
                                                               "det.txt")
        out_dir = os.path.join(root, "out")
        os.makedirs(out_dir, exist_ok=True)
        results = {}
        for method in methods:
            m = run_method(method, img_dir, gt, det, out_dir, device=device)
            results[method] = m
            print(f"{method:11s} MOTA {m['MOTA']:6.2f}  IDF1 {m['IDF1']:6.2f}"
                  f"  HOTA {m['HOTA']:6.2f}  IDSW {m['IDSW']:4.0f}  "
                  f"({m['seconds']:.1f}s)", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser("gauntlet")
    ap.add_argument("methods", nargs="*", default=None)
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if a method leaves its pinned MOTA/IDF1/"
                         "HOTA band")
    ap.add_argument("--dir", default="",
                    help="render the scene here (reused when its gt.txt "
                         "exists) instead of a temporary directory")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    results = run(args.methods, args.dir, args.device)
    if args.check:
        bad = band_failures(results)
        if bad:
            print("GAUNTLET CHECK FAILED:\n  " + "\n  ".join(bad))
            sys.exit(1)
        print("gauntlet check OK: all methods inside pinned bands")
    return results


if __name__ == "__main__":
    main()
