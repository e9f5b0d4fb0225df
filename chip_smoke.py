#!/usr/bin/env python3
"""Smoke run of `reid_tpu_torch` on one NVIDIA card: the quickest proof that
the port builds its kernels and runs its main path there.

    python3 chip_smoke.py             # on one card, about 1 min
    python3 chip_smoke.py --profile   # the same, tracing both track runs

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build    nvcc of every kernel source in reid_tpu_torch/csrc, all
              started together, into reid_tpu_torch/_build;
  3. kernels  each kernel at each call site of the main path, on a batch of
              B = 2048 crops (a 32-frame chunk of 64 detection slots): held
              against its plain PyTorch version (conv3x3_s8 exactly, the
              fused SE block at rtol = atol = 1e-4 on >= 99.9% of elements
              and 5e-2 on all), and timed with CUDA events (median of 20
              after warm-up) beside the plain version, the least time the
              card could take, and the one PyTorch call that computes the
              same function where there is one. The fused block is also
              compared, without a limit, with its plain version summed in
              torch's order (`share_tight_torch_order`), which shows how
              much room the limit has when the summation orders differ;
  4. track    `reid_tpu_torch.cli.track` (the body of `track_main`, which
              returns the pipeline) on a synthetic MOT16-load
              scene (1920x1080, 50 moving boxes in 64 slots, 128 track
              slots, 256x128 crops, SERes18 with 751 classes, --int8):
              --chunk 32 over 64 frames, then the per-frame step path over
              8 frames; launch counts are zeroed just before each run and
              read just after it;
  5. embed    the card's int8 embed against the same quantized model on the
              CPU (plain kernel versions), cosine of [feat || logits].
Then the `kernels` line, the nvidia-smi line and, last, the result line.
Everything is also written to chiprun_out/chip_smoke.json.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Dense peaks by card (NVIDIA data sheets): int8 tensor ops/s, bytes/s.
PEAKS = {"H100 PCIe": (1513e12, 2.0e12), "H100 NVL": (1671e12, 3.9e12),
         "H200": (1979e12, 4.8e12), "H100": (1979e12, 3.35e12)}

# Call sites of each kernel on the main path: module path (and, for
# conv3x3_s8, the per-image shape H, W, Cin, Cout).
K1_SITES = [("block21/conv2", (32, 16, 128, 128)),
            ("block31/conv2", (16, 8, 256, 256))]
K2_SITES = ["block22", "block32", "block41", "block42"]
K1_SOURCE, K1_REPLACES = ("reid_tpu_torch/csrc/qconv.cu",
                          "reid_tpu/ops/qconv.py:116")
K2_SOURCE, K2_REPLACES = ("reid_tpu_torch/csrc/qblock.cu",
                          "reid_tpu/ops/qblock.py:313")

RESULTS = {}


def emit(phase, **kw):
    RESULTS[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def peaks(kind):
    for key, val in PEAKS.items():
        if key in kind:
            return val
    raise RuntimeError(f"no published peaks for {kind!r}")


def time_ms(fn, reps=20, warm=3):
    """Median of `reps` CUDA-event timings of fn() after `warm` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(ops, nbytes, kind):
    rate, bw = peaks(kind)
    t_ops, t_bytes = ops / rate * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def agreement(got, want, tight=1e-4, loose=5e-2):
    """(share of elements within rtol = atol = `tight`, max abs err,
    whether all are within `loose`)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = (err <= tight + tight * want.abs()).double().mean().item()
    return ok, err.max().item(), bool((err <= loose + loose * want.abs())
                                      .all())


def within(got, want, share=0.999):
    """The fused block's tolerance; returns (share within tight, max err)."""
    ok, err, all_loose = agreement(got, want)
    if ok < share or not all_loose:
        raise AssertionError(f"kernel vs plain: {ok:.6f} within 1e-4, "
                             f"max err {err}")
    return ok, err


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peaks=dict(zip(("int8_ops", "bytes"),
                                                 peaks(kind))))
    return smi, kind


def phase_build():
    from reid_tpu_torch.ops import _lib
    names = sorted(f[:-3] for f in os.listdir(_lib.CSRC) if f.endswith(".cu"))
    res = _lib.build(names)
    logs = {}
    for n in names:
        with open(os.path.join(_lib.BUILD_DIR, n + ".log")) as f:
            logs[n] = [ln.strip() for ln in f if "Used" in ln or "spill" in ln]
    emit("build", kernels=names, built=res["built"], seconds=res["seconds"],
         ptxas=logs)


def quantized_trunk(dev, b, num_classes=751, seed=0):
    """The main path's quantized SERes18, and the input each kernel call
    site receives when it embeds a batch of `b` random crops."""
    import torch
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import quantize, quantized_model

    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model("seres18", num_classes=num_classes,
                        dtype=torch.bfloat16, device=dev)
    crops = torch.randn((b, 256, 128, 3), generator=gen, device=dev)
    qm = quantized_model(model, quantize(model, [crops[:32]]))
    seen = {}

    def grab(name):
        def hook(_m, args):
            seen[name] = args[0]
        return hook

    hooks = [qm.get_submodule(s.replace("/", ".")).register_forward_pre_hook(
        grab(s)) for s in [k for k, _ in K1_SITES] + K2_SITES]
    with torch.inference_mode():
        qm(crops)
    for h in hooks:
        h.remove()
    return qm, seen


def phase_kernels(kind, b):
    import torch
    from reid_tpu_torch.ops import qblock, qconv
    from reid_tpu_torch.utils.quantize import _im2col, quantize_input

    dev = torch.device("cuda")
    qm, seen = quantized_trunk(dev, b)
    rows = []
    with torch.inference_mode():
        for site, (h, w, cin, cout) in K1_SITES:
            mod = qm.get_submodule(site.replace("/", "."))
            assert mod.route, site
            xq = quantize_input(seen[site], mod.sx).contiguous()
            assert tuple(xq.shape[1:]) == (h, w, cin), xq.shape
            args = (xq, mod.mm.wt, mod.scale)
            got = qconv.conv3x3_s8(*args)
            want = qconv.conv3x3_s8_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert torch.equal(got, want), (site, err)
            cols, _ = _im2col(xq, 3, 1, 1, 9 * cin)
            wcol = mod.mm.wt.T
            m = xq.shape[0] * h * w
            ms = time_ms(lambda: qconv.conv3x3_s8(*args))
            plain_ms = time_ms(lambda: qconv.conv3x3_s8_plain(*args))
            lib_ms = time_ms(lambda: torch._int_mm(cols, wcol))
            del cols
            bms, by = bound(2 * m * cout * 9 * cin,
                            m * cin + cout * 9 * cin + 4 * cout
                            + 2 * m * cout, kind)
            rows.append(dict(name=f"conv3x3_s8 {site}", route="cuda",
                             source=K1_SOURCE, replaces=K1_REPLACES,
                             site=[h, w, cin, cout], batch=xq.shape[0],
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, library_ms=lib_ms))
            emit(f"kernel {rows[-1]['name']}", **rows[-1])
        for site in K2_SITES:
            mod = qm.get_submodule(site)
            x = seen[site].contiguous()
            p, ibn = mod.p, mod.ibn
            bsz, h, w, cin = x.shape
            cout, mip = p.w2.shape[0], p.wfc1.shape[1]
            got = qblock.se_basic_block_s8(x, p, ibn=ibn)
            want = qblock.se_basic_block_s8_plain(x, p, ibn=ibn)
            torch.cuda.synchronize()
            share, err = within(got.float(), want.float())
            del want
            share_t, err_t, loose_t = agreement(
                got.float(), qblock.se_basic_block_s8_plain(
                    x, p, ibn=ibn, kernel_order=False).float())
            ms = time_ms(lambda: qblock.se_basic_block_s8(x, p, ibn=ibn))
            plain_ms = time_ms(
                lambda: qblock.se_basic_block_s8_plain(x, p, ibn=ibn))
            m = bsz * h * w
            down = p.wd is not None
            ops = (2 * m * cout * 9 * (cin + cout)
                   + (2 * m * cout * cin if down else 0)
                   + 4 * bsz * cout * mip)
            nbytes = (2 * m * cin + 9 * cout * (cin + cout)
                      + (cout * cin if down else 0) + 4 * cout * mip
                      + 4 * 9 * cout + 2 * m * cout)
            bms, by = bound(ops, nbytes, kind)
            rows.append(dict(name=f"se_basic_block_s8 {site}", route="cuda",
                             source=K2_SOURCE, replaces=K2_REPLACES,
                             site=[h, w, cin, cout, int(ibn)], batch=bsz,
                             down=down, max_abs_err=err, share_tight=share,
                             share_tight_torch_order=share_t,
                             max_abs_err_torch_order=err_t,
                             within_loose_torch_order=loose_t, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=None))
            emit(f"kernel {rows[-1]['name']}", **rows[-1])
    del seen, qm
    torch.cuda.empty_cache()
    return rows


def write_scene(root, n_frames, n_real=50, hw=(1080, 1920), seed=0):
    """MOT16-load scene as .npy frames plus det.txt: 50 boxes of person
    aspect moving across a noisy background, each painted its own colour."""
    rng = np.random.default_rng(seed)
    h, w = hw
    heights = np.exp(rng.uniform(np.log(60), np.log(260), n_real))
    widths = heights * 0.41
    x0 = rng.uniform(0, w - widths - 200, n_real)
    y0 = rng.uniform(0, h - heights - 10, n_real)
    vx = rng.normal(0, 3.0, n_real)
    colors = rng.integers(40, 255, (n_real, 3), dtype=np.uint8)
    fdir = os.path.join(root, "frames")
    os.makedirs(fdir)
    lines = []
    for t in range(n_frames):
        frame = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        for j in range(n_real):
            x = float(np.clip(x0[j] + vx[j] * t, 0, w - widths[j] - 1))
            y = float(y0[j])
            frame[int(y):int(y + heights[j]), int(x):int(x + widths[j])] = \
                colors[j]
            lines.append(f"{t + 1},-1,{x:.2f},{y:.2f},{widths[j]:.2f},"
                         f"{heights[j]:.2f},0.9")
        np.save(os.path.join(fdir, f"{t + 1:06d}.npy"), frame)
    det = os.path.join(root, "det.txt")
    with open(det, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fdir, det


def profiled(fn, path):
    """fn() under torch.profiler; the device kernels by total time go to
    `path`, and their summed time is returned in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"device kernel time {busy_ms:.3f} ms\n")
        for e in kernels:
            f.write(f"{e.self_device_time_total / 1e3:10.3f} ms "
                    f"{e.count:7d}x  {e.key[:150]}\n")
    return out, busy_ms


def run_track(argv, profile_to=None):
    """One run of the track path with the launch counts zeroed just before
    and read just after; traced with torch.profiler when `profile_to`
    names a file."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    busy_ms = None
    if profile_to:
        pipe, busy_ms = profiled(lambda: cli.track(argv, device="cuda"),
                                 profile_to)
    else:
        pipe = cli.track(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    sites = _lib.site_launch_counts()
    rows = sum(int(np.sum(r["valid"])) for r in pipe.results)
    ids = {int(i) for r in pipe.results for i in r["ids"][r["valid"]]}
    boxes = np.concatenate([r["tlwh"][r["valid"]] for r in pipe.results])
    assert np.all(np.isfinite(boxes)) and boxes.shape[1] == 4
    assert all(np.all(r["ids"][r["valid"]] > 0) for r in pipe.results)
    return dict(frames=pipe.frames, rows=rows, distinct_ids=len(ids),
                timing_ms_per_frame=pipe.timing_summary(),
                fps=pipe.frames / pipe.timing["total"], wall_s=wall,
                device_kernel_ms=busy_ms, launches=counts,
                site_launches={f"{n} {list(s)}": c
                               for (n, s), c in sites.items()})


def phase_track(tmp, n_frames, chunk, step_frames, profile=False):
    fdir, det = write_scene(tmp, n_frames)
    base = ["--detections", det, "--frames_dir", fdir, "--int8",
            "--max_dets", "64", "--num_classes", "751", "--crop_hw", "256",
            "128"]

    def trace(name):
        return os.path.join(OUT_DIR, f"profile_{name}.txt") if profile \
            else None
    chunked = run_track(base + ["--chunk", str(chunk), "--save_txt",
                                os.path.join(tmp, "chunk.txt")],
                        trace("chunked"))
    emit("track chunked", chunk=chunk, **chunked)
    step = run_track(base + ["--chunk", "1", "--max_frames", str(step_frames),
                             "--save_txt", os.path.join(tmp, "step.txt")],
                     trace("step"))
    emit("track step", **step)
    for run, name in ((chunked, "chunked"), (step, "step")):
        assert run["rows"] > 0 and run["distinct_ids"] >= 40, (name, run)
        for k in ("conv3x3_s8", "se_basic_block_s8"):
            assert run["launches"].get(k, 0) > 0, (name, k, run["launches"])
    return chunked, step


def phase_embed():
    """The card's int8 embed against the CPU's on the same quantized model
    and the same 16 crops; the CPU runs every kernel's plain version."""
    import torch
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import (QuantState, quantize,
                                               quantized_model)

    gen = torch.Generator().manual_seed(1)
    crops = torch.randn((16, 256, 128, 3), generator=gen)
    cpu = build_model("seres18", num_classes=751, dtype=torch.bfloat16,
                      device="cpu")
    qs = quantize(cpu, [crops])
    q_cpu = quantized_model(cpu, qs)
    card = build_model("seres18", num_classes=751, dtype=torch.bfloat16,
                       device="cuda")
    card.load_state_dict(cpu.state_dict())
    q_card = quantized_model(card, QuantState(
        {k: v.cuda() for k, v in qs.kernels.items()},
        {k: v.cuda() for k, v in qs.w_scales.items()}, qs.act_scales))
    with torch.inference_mode():
        e_c = torch.cat(q_cpu(crops), 1).float()
        e_g = torch.cat(q_card(crops.cuda()), 1).float().cpu()
    cos = torch.nn.functional.cosine_similarity(e_c, e_g, dim=1)
    emit("embed", crops=16, min_cosine=cos.min().item(), threshold=0.999)
    assert cos.min().item() >= 0.999, cos


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace both track runs with torch.profiler into "
                         "chiprun_out/profile_{chunked,step}.txt")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    import reid_tpu_torch  # noqa: F401  (fails outside the repo)

    smi, kind = phase_device()
    phase_build()
    rows = phase_kernels(kind, 2048)
    with tempfile.TemporaryDirectory() as tmp:
        chunked, _ = phase_track(tmp, 64, 32, 8, args.profile)
    phase_embed()
    sites = chunked["site_launches"]
    for row in rows:
        kname = row["name"].split()[0]
        row["launches"] = sites.get(f"{kname} {row['site']}", 0)
        assert row["launches"] > 0, row
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = {"kernels": [{k: row[k] for k in keys} for row in rows]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"results": RESULTS, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
