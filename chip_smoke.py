#!/usr/bin/env python3
"""Smoke run of `reid_tpu_torch` on one NVIDIA card: the quickest proof that
the port builds its kernels and runs its main path there.

    python3 chip_smoke.py             # on one card, about 5 min of command
    python3 chip_smoke.py --profile   # the same, tracing the track runs
                                      # and the retrieval run

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build    nvcc of every kernel source in reid_tpu_torch/csrc, all
              started together, into reid_tpu_torch/_build; each kernel's
              registers and spill bytes from the -Xptxas -v logs (no kernel
              may spill);
  3. kernels  each kernel at each call site of the track path, on a batch of
              B = 2048 crops (a 32-frame chunk of 64 detection slots). K1
              (`conv3x3_s8`, csrc/qconv.cu) and K2's three GEMMs
              (`se_basic_block_s8`, csrc/qblock.cu) run on the Hopper
              mainloop of csrc/wgmma_s8.cuh: a persistent grid, one producer
              thread issuing per tap and 64 or 128 channels a 4-D TMA box of
              the NHWC activation (the SAME halo zero-filled by the
              hardware) and a 2-D box of the packed weight into a 3-6 stage
              mbarrier ring, two consumer warpgroups on wgmma m64nNk32 s8
              (N = 256 where Cout allows), each with its own epilogue; K2's
              keep the IBN statistics, the SE pooling and the residual on
              chip where a tile holds what they need. K3 and K5 run on the
              same mainloop, one launch a call: K3 with N tiles of the nine
              taps of 16 channels and a box of whole image rows plus a
              halo row above and below, its product summed over the taps
              on chip (along x by shuffles, along y through shared
              memory) while the other consumer warpgroup runs its
              products; K5 with TMA's im2col mode loading each tap's rows
              of 128 or 256 flat output pixels; K4 with A read by
              ldmatrix from one TMA-loaded slab of a tile's rows and
              their halo per K chunk, for all nine taps, and fed to
              wgmma from registers. Each is held
              against its plain PyTorch version (conv3x3_s8 exactly, the
              fused SE block at rtol = atol = 1e-4 on >= 99.9% of elements
              and 5e-2 on all, and whether it is bit-equal), and timed with
              CUDA events (median of 20 after warm-up) beside the plain
              version, the least time the card could take, and the one
              PyTorch call that computes the same function where there is
              one; K1 and K2 also back to back (`queued_ms`, and the
              wrapper's `host_ms`). K2's rows add its time before the wgmma
              design (`before_ms`), a torch.profiler split of one call's
              launches with the bytes each must move, their count and sum
              (`launches_per_call`, `design_bytes`), and where images span
              tiles the share of outputs that the per-tile summation order
              moves against one part an image (`moved_by_tile_order`).
              The fused block is also
              compared, without a limit, with its plain version summed in
              torch's order (`share_tight_torch_order`), which shows how
              much room the limit has when the summation orders differ.
              At K1's call sites K3-K5 (`conv3x3_s8_ncat`, `_bitshift`,
              `_dma`) too, each held equal to its plain version and to K1
              and timed the same way, with its time before this design
              (`before_ms`), a torch.profiler split of one call's launches
              (`launches_per_call`) and the device memory a call allocates
              beside its output (`scratch_bytes`, 0 for each);
  3b. probe   `reid_tpu_torch.qconv_probe.run()`, the path of K3-K5: the
              bf16 conv, `torch._int_mm` and K1/K3/K4/K5 at the probe's
              four layer shapes (B = 512), every kernel exact against its
              plain version and K1; launch counts zeroed just before the
              run and read just after it;
  4. track    `reid_tpu_torch.cli.track` (the body of `track_main`, which
              returns the pipeline) on a synthetic MOT16-load
              scene (1920x1080, 50 moving boxes in 64 slots, 128 track
              slots, 256x128 crops, SERes18 with 751 classes, --int8):
              --chunk 32 over 64 frames, then the per-frame step path over
              8 frames; launch counts are zeroed just before each run and
              read just after it. Then the same with botsort and its
              camera-motion compensation on a scene whose textured
              background the camera pans by PAN px a frame: the chunked
              path's device affines within 1 px of the pan and within
              1e-3 px of the CPU's on the same frames, the step path's
              (`estimate_affine` on the host) within 1 px of the pan; then
              strongsort --chunk 32 once more without --int8, the default
              bf16 embed (cuDNN), its fps and stage split;
  4b. track with the built-in detectors, on phase 4's scene, the step
              path: YOLOv5s with its trunk in int8 (DET_ARGS: --det_size
              288 512, --conf_thres 0.25, random weights from a generator
              seeded 1, calibrated on the first 8 frames) over 16 frames:
              fps, the detector's ms a frame (timed around it, the device
              synchronised), crop_embed and associate, valid detections a
              frame, and K1's launches at the detector's sites, zeroed
              just before the run and read just after (5 at 1x18x32 c128
              and 2 at 1x9x16 c256 a frame, exactly). Then the detector on
              the card against the same weights and QuantState on the CPU
              on 2 frames: equal valid counts and each card box within
              0.5 px of the CPU's box of the same candidate (the share
              within 0.02 px, and of output slots holding the same box,
              reported: the random init scores every cell within ~1e-4 of
              0.25, so which candidates NMS keeps turns on last bits);
              K1 at the two sites (exact, timed as in phase 3); one
              frame's launches and device time (torch.profiler); and
              `nms_fixed` alone. CenterNetLite (f32, no kernel of ours)
              over 8 frames: fps and detections a frame;
  4c. gauntlet `reid_tpu_torch.gauntlet`: its 300-frame distractor scene
              rendered into a temporary directory, the five methods
              through `track_main --gt` (--chunk 16, --conf_thres 0.3,
              --max_dets 64): MOTA, IDF1 and HOTA of each against its
              CHECK_BANDS, which it must not leave;
  5. embed    the card's int8 embed against the same quantized model on the
              CPU (plain kernel versions), cosine of [feat || logits];
  6. retrieval `reid_tpu_torch.cli.inference` (the body of
              `inference_main`) on an in-memory synthetic split of
              Market-1501's size: 3,368 queries and 19,732 gallery images
              of 256x128, 750 ids, 6 cameras; SERes18 in f32 with 751
              classes (D = 1,263) and random weights (seed 0); --bs 64,
              TTA flip, camera de-bias, k1 = 20, k2 = 6, eps 0.55,
              --search_option dense. CMC@1/5/10, mAP, seconds per stage and
              peak device memory; launch counts are zeroed just before the
              run and read just after it;
  7. retrieval --int8: the same run with the int8 serving embed, whose
              f32 trunk runs both int8 kernels in their f32-in, f32-out
              form; its launch counts likewise, and the cosine of its
              gallery embeddings to phase 6's reported;
  8. kernels, f32 form: as phase 3 (the same limits) at each call site of
              the `--int8` retrieval trunk, on one embed batch of 128
              images (64 query images and their flips);
  9. distance kernels, held against their plain versions (rtol = atol =
              1e-4 for sqeuclidean, 1e-5 for l1) and timed like phase 3.
              sqeuclidean (K6) is a pipelined SIMT f32 GEMM: transposed,
              zero-padded copies of both operands (in its time), 128 x 144
              tiles streamed through a 4-stage cp.async ring, 8 x 9 outputs
              a thread read as float4 quads, each output summed by fmaf
              over k ascending; l1 (K7) is the 128 x 128 SIMT tile kernel.
              Both run on
              the operands of phase 6's first Jaccard call: sqeuclidean at
              the path's query block (1,024 of the de-biased unit features
              against all 23,100, D = 1,263), with the share of rows whose
              top-20 indices match; l1 on the V encoding recomputed from
              those features, a slab of 1,024 rows against N = D = 23,100,
              and one full 23,100^3 call;
 10. retrieval on the card against the CPU: the post-embed half
              (`evaluate_features`) on the same 1,024 features (160
              queries, 864 gallery images: ids 0-31), dense and sparse:
              CMC within 1/Q at every rank and mAP within 1e-2, with the
              share of Jaccard entries within 1e-4 reported, and a second
              card run equal to the first bit for bit; from the same
              features and ranking the Jaccard within 1e-5 everywhere, and
              the top-20 sets equal on >= 99.9% of rows (near-ties: see
              `phase_retrieval_cpu`); then the f32 and the int8 TTA embed,
              card against CPU, on 16 images: cosine >= 0.99999 and
              >= 0.999.
Then the `kernels` line, the nvidia-smi line and, last, the result line.
Everything is also written to chiprun_out/chip_smoke.json.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from reid_tpu_torch.utils.timing import (bound, peaks, time_ms,
                                         time_queued_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Call sites of each kernel on the main path: module path (and, for
# conv3x3_s8, the per-image shape H, W, Cin, Cout).
K1_SITES = [("block21/conv2", (32, 16, 128, 128)),
            ("block31/conv2", (16, 8, 256, 256))]
K2_SITES = ["block22", "block32", "block41", "block42"]
# the detector in the loop: YOLOv5s with its trunk in int8 at the CLI's
# default --det_size, one image a call. K1 runs at the seven bottleneck 3x3
# convs with 128 or 256 channels: five at 18x32 with 128 (l6.m0-m2,
# l13.m0, l20.m0) and two at 9x16 with 256 (l8.m0, l23.m0)
DET_ARGS = ["--detector", "yolov5", "--yolo_variant", "yolov5s",
            "--det_size", "288", "512", "--int8", "--conf_thres", "0.25",
            "--max_dets", "64", "--num_classes", "751", "--crop_hw", "256",
            "128"]
DET_K1_SITES = [("l6/m0/cv2/conv", (18, 32, 128, 128)),
                ("l8/m0/cv2/conv", (9, 16, 256, 256))]
DET_K1_PER_FRAME = {(18, 32, 128, 128): 5, (9, 16, 256, 256): 2}
K1_SOURCE, K1_REPLACES = ("reid_tpu_torch/csrc/qconv.cu",
                          "reid_tpu/ops/qconv.py:116")
# K3-K5: the other forms of K1's convolution, on the qconv probe's path
VARIANT_SOURCE = "reid_tpu_torch/csrc/qconv_variants.cu"
VARIANT_REPLACES = {"conv3x3_s8_ncat": "reid_tpu/ops/qconv.py:188",
                    "conv3x3_s8_bitshift": "reid_tpu/ops/qconv.py:273",
                    "conv3x3_s8_dma": "reid_tpu/ops/qconv.py:355"}
# the botsort scene's camera pan in px per frame: one bin of the device
# estimator's 4x downscaled plane at 1080p in each axis
PAN = (4, -4)
# K3-K5's ms at K1_SITES (B = 2048, bf16) and at the probe's four
# configurations (B = 512) before their wgmma designs (K3, K5: two
# launches a call on the mma.sync core, the product or the im2col buffer
# in device memory; K4: one mma.sync slab kernel), measured as here on an
# NVIDIA H100 80GB HBM3 at 700 W
VARIANT_BEFORE_MS = {
    "conv3x3_s8_ncat": {"block21/conv2": 4.536, "block31/conv2": 2.550,
                        "stage2 32x16 c128": 1.216,
                        "stage3 16x8  c256": 0.6505,
                        "stage4 16x8  c512": 1.558,
                        "fc-stage4 8x4 c512": 0.4273},
    "conv3x3_s8_bitshift": {"block21/conv2": 0.7787,
                            "block31/conv2": 0.6965,
                            "stage2 32x16 c128": 0.2319,
                            "stage3 16x8  c256": 0.2202,
                            "stage4 16x8  c512": 0.6303,
                            "fc-stage4 8x4 c512": 0.2023},
    "conv3x3_s8_dma": {"block21/conv2": 1.554, "block31/conv2": 1.164,
                       "stage2 32x16 c128": 0.4560,
                       "stage3 16x8  c256": 0.3327,
                       "stage4 16x8  c512": 0.9920,
                       "fc-stage4 8x4 c512": 0.2762}}
K2_SOURCE, K2_REPLACES = ("reid_tpu_torch/csrc/qblock.cu",
                          "reid_tpu/ops/qblock.py:313")
# K2's ms at K2_SITES before its wgmma design (the launch sequence on the
# mma.sync core of csrc/igemm_s8.cuh), measured as here on an NVIDIA H100
# 80GB HBM3 at 700 W: bf16 at B = 2048, f32 at B = 128
K2_BEFORE_MS = {"torch.bfloat16": (3.618, 2.480, 5.726, 6.522),
                "torch.float32": (0.3817, 0.2940, 0.5333, 0.5523)}
K6_REPLACES = "reid_tpu/ops/distance.py:85"
K7_REPLACES = "reid_tpu/ops/distance.py:149"
DIST_SOURCE = "reid_tpu_torch/csrc/distance.cu"
# the retrieval operating point: Market-1501's test split
N_QUERY, N_GALLERY, N_IDS, N_CAMS, N_CLASSES = 3368, 19732, 750, 6, 751

RESULTS = {}


def emit(phase, **kw):
    RESULTS[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
         cuda=torch.version.cuda, peaks=peaks(kind))
    return smi, kind


def ptxas_kernels(log):
    """Registers and spill bytes of each kernel that `nvcc -Xptxas -v`
    compiled, from its log: [{kernel, registers, spill_stores,
    spill_loads}] in the log's order, names demangled where c++filt is
    installed."""
    import re
    import shutil
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(kernel=m.group(1))
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, name in zip(rows, names):
            r["kernel"] = name.split("(")[0]
    return rows


def phase_build():
    """Every kernel source built at once; each kernel's registers and
    spills from ptxas. No kernel may spill: the wgmma consumers of K1,
    K2 and K5 hold 128 s32 accumulators a thread, K3's 144."""
    from reid_tpu_torch.ops import _lib
    names = sorted(f[:-3] for f in os.listdir(_lib.CSRC) if f.endswith(".cu"))
    res = _lib.build(names)
    ptxas = {}
    for n in names:
        with open(os.path.join(_lib.BUILD_DIR, n + ".log")) as f:
            ptxas[n] = ptxas_kernels(f.read())
    emit("build", kernels=names, built=res["built"], seconds=res["seconds"],
         ptxas=ptxas)
    for n in names:
        assert ptxas[n], (n, "no ptxas report: was the library rebuilt?")
        for k in ptxas[n]:
            assert k["spill_stores"] == 0 and k["spill_loads"] == 0, k


def quantized_trunk(dev, dtype, calib, crops, num_classes=751):
    """The quantized SERes18 of a path (bf16 for tracking, f32 for
    retrieval), calibrated on `calib`, and the input each kernel call site
    receives when it embeds the batch `crops`."""
    import torch
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import quantize, quantized_model

    model = build_model("seres18", num_classes=num_classes, dtype=dtype,
                        device=dev)
    qm = quantized_model(model, quantize(model, [calib]))
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


def k1_row(kind, mod, xq, dtype, name, path):
    """K1 (`conv3x3_s8`) on `xq`, the int8 input of the quantized conv
    `mod` at a call site: exactly equal to its plain version, timed beside
    the plain version and `torch._int_mm` on a ready im2col (20 calls
    each, and 20 back to back). Returns the kernels-line row (emitted)
    and the kernel's output."""
    import torch
    from reid_tpu_torch.ops import qconv
    from reid_tpu_torch.utils.quantize import _im2col

    b, h, w, cin = xq.shape
    cout = mod.mm.wt.shape[0]
    esize = torch.finfo(dtype).bits // 8
    args = (xq, mod.mm.wt, mod.scale, dtype)
    got = qconv.conv3x3_s8(*args)
    want = qconv.conv3x3_s8_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), (name, err)
    del want
    cols, _ = _im2col(xq, 3, 1, 1, 9 * cin)
    wcol = mod.mm.wt.T
    m = b * h * w
    ms = time_ms(lambda: qconv.conv3x3_s8(*args))
    plain_ms = time_ms(lambda: qconv.conv3x3_s8_plain(*args))
    lib_ms = time_ms(lambda: torch._int_mm(cols, wcol))
    queued = time_queued_ms(lambda: qconv.conv3x3_s8(*args))
    lib_queued = time_queued_ms(lambda: torch._int_mm(cols, wcol))
    del cols
    bms, by = bound(2 * m * cout * 9 * cin,
                    m * cin + cout * 9 * cin + 4 * cout + esize * m * cout,
                    kind)
    row = dict(name=name, route="cuda", source=K1_SOURCE,
               replaces=K1_REPLACES, path=path, site=[h, w, cin, cout],
               batch=b, out_dtype=str(dtype), max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, queued_ms=queued[0], host_ms=queued[1],
               library_queued_ms=lib_queued[0],
               library_host_ms=lib_queued[1])
    emit(f"kernel {name}", **row)
    return row, got


def phase_kernels(kind, dtype, calib, crops, path, suffix="",
                  variants=False):
    """K1 and K2 at each call site of `path`'s quantized trunk (`dtype`
    in and out), on the inputs that embedding `crops` gives them; with
    `variants`, K3-K5 at K1's call sites too, each held equal to its plain
    version and to K1."""
    import torch
    from reid_tpu_torch import qconv_probe
    from reid_tpu_torch.ops import qblock, qconv
    from reid_tpu_torch.utils.quantize import quantize_input

    qm, seen = quantized_trunk(crops.device, dtype, calib, crops)
    esize = torch.finfo(dtype).bits // 8
    rows, split_later = [], []
    with torch.inference_mode():
        for site, (h, w, cin, cout) in K1_SITES:
            mod = qm.get_submodule(site.replace("/", "."))
            assert mod.route, site
            xq = quantize_input(seen[site], mod.sx).contiguous()
            assert tuple(xq.shape[1:]) == (h, w, cin), xq.shape
            row, got = k1_row(kind, mod, xq, dtype,
                              f"conv3x3_s8 {site}{suffix}", path)
            rows.append(row)
            bms, by, lib_ms = row["bound_ms"], row["bound_by"], \
                row["library_ms"]
            wn = qconv.pack_ncat_weight(mod.mm.wt)
            for kernel, plain_fn, vname in (
                    qconv_probe.KERNELS.values() if variants else []):
                if vname == qconv.NAME:
                    continue
                vargs = (xq, mod.mm.wt, wn, mod.scale, dtype)
                scratch = scratch_bytes(lambda: kernel(*vargs))
                vgot, vwant = kernel(*vargs), plain_fn(*vargs)
                torch.cuda.synchronize()
                verr = (vgot.float() - vwant.float()).abs().max().item()
                assert torch.equal(vgot, vwant), (vname, site, verr)
                assert torch.equal(vgot, got), (vname, site)
                del vgot, vwant
                rows.append(dict(
                    name=f"{vname} {site}{suffix}", route="cuda",
                    source=VARIANT_SOURCE, replaces=VARIANT_REPLACES[vname],
                    path="qconv probe", site=[h, w, cin, cout],
                    batch=xq.shape[0], out_dtype=str(dtype), max_abs_err=verr,
                    ms=time_ms(lambda: kernel(*vargs)),
                    before_ms=VARIANT_BEFORE_MS.get(vname, {}).get(site),
                    plain_ms=time_ms(lambda: plain_fn(*vargs), reps=3,
                                     warm=1),
                    bound_ms=bms, bound_by=by, library_ms=lib_ms,
                    scratch_bytes=scratch))
                assert scratch == 0, rows[-1]
                # launches counted after every timing of the phase (a
                # torch.profiler trace slows the process's later launches)
                split_later.append((rows[-1], kernel, vargs))
            del got
        for i, site in enumerate(K2_SITES):
            mod = qm.get_submodule(site)
            x = seen[site].contiguous()
            p, ibn = mod.p, mod.ibn
            bsz, h, w, cin = x.shape
            cout, mip = p.w2.shape[0], p.wfc1.shape[1]
            assert x.dtype == dtype, (site, x.dtype)

            def call():
                return qblock.se_basic_block_s8(x, p, ibn, dtype)
            got = call()
            want = qblock.se_basic_block_s8_plain(x, p, ibn, dtype)
            torch.cuda.synchronize()
            share, err = within(got.float(), want.float())
            bit_equal = bool(torch.equal(got, want))
            del want
            share_t, err_t, loose_t = agreement(
                got.float(), qblock.se_basic_block_s8_plain(
                    x, p, ibn, dtype, kernel_order=False).float())
            # where images span tiles: the share of outputs that the
            # per-tile summation order moves against one part an image
            moved = None
            if len(qblock.tile_segments(h, w, cout)) > 1:
                one = plain_one_part(x, p, ibn, dtype)
                moved = (got != one).double().mean().item()
                del one
            ms = time_ms(call)
            plain_ms = time_ms(
                lambda: qblock.se_basic_block_s8_plain(x, p, ibn, dtype))
            queued = time_queued_ms(call)
            m = bsz * h * w
            down = p.wd is not None
            ops = (2 * m * cout * 9 * (cin + cout)
                   + (2 * m * cout * cin if down else 0)
                   + 4 * bsz * cout * mip)
            nbytes = (esize * m * cin + 9 * cout * (cin + cout)
                      + (cout * cin if down else 0) + 4 * cout * mip
                      + 4 * 9 * cout + esize * m * cout)
            bms, by = bound(ops, nbytes, kind)
            split = launch_split(call)
            for k, n in zip(split, k2_launch_bytes(
                    [k[0] for k in split], bsz, h, w, cin, cout, mip, down,
                    esize)):
                k.append(n)
            rows.append(dict(name=f"se_basic_block_s8 {site}{suffix}",
                             route="cuda", source=K2_SOURCE,
                             replaces=K2_REPLACES, path=path,
                             site=[h, w, cin, cout, int(ibn)], batch=bsz,
                             down=down, max_abs_err=err, bit_equal=bit_equal,
                             moved_by_tile_order=moved,
                             share_tight=share,
                             share_tight_torch_order=share_t,
                             max_abs_err_torch_order=err_t,
                             within_loose_torch_order=loose_t, ms=ms,
                             before_ms=K2_BEFORE_MS[str(dtype)][i],
                             plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=None,
                             queued_ms=queued[0], host_ms=queued[1],
                             launches_per_call=len(split),
                             design_bytes=sum(k[2] for k in split),
                             device_split_ms=split))
            emit(f"kernel {rows[-1]['name']}", **rows[-1])
            del got
        for row, kernel, vargs in split_later:
            row["launches_per_call"] = len(launch_split(
                lambda: kernel(*vargs)))
            assert row["launches_per_call"] == 1, row
            emit(f"kernel {row['name']}", **row)
    del seen, qm, split_later
    torch.cuda.empty_cache()
    return rows


def textured_background(rng, h, w, grain=2):
    """Uniform noise on a grid of `grain` px, bilinearly upsampled: a
    texture with detail at every scale the GMC estimator samples."""
    import torch
    coarse = torch.from_numpy(rng.integers(
        0, 256, (h // grain + 2, w // grain + 2, 3)).astype(np.float32))
    up = torch.nn.functional.interpolate(
        coarse.permute(2, 0, 1)[None], scale_factor=grain, mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0)[:h, :w]
    return up.clamp(0, 255).to(torch.uint8).numpy()


def write_scene(root, n_frames, n_real=50, hw=(1080, 1920), seed=0,
                pan=None):
    """MOT16-load scene as .npy frames plus det.txt: 50 boxes of person
    aspect moving across a noisy background, each painted its own colour.
    With `pan` = (px, py) the background is a fixed texture that the
    camera pans across, so its content and the boxes move by (px, py) px
    per frame."""
    rng = np.random.default_rng(seed)
    h, w = hw
    px, py = pan or (0, 0)
    heights = np.exp(rng.uniform(np.log(60), np.log(260), n_real))
    widths = heights * 0.41
    x0 = rng.uniform(0, w - widths - 200 - abs(px) * n_frames, n_real)
    y0 = rng.uniform(max(0, -py * n_frames),
                     h - heights - 10 - max(0, py * n_frames), n_real)
    vx = rng.normal(0, 3.0, n_real)
    colors = rng.integers(40, 255, (n_real, 3), dtype=np.uint8)
    if pan:
        mh, mw = abs(py) * n_frames, abs(px) * n_frames
        bg = textured_background(rng, h + mh, w + mw)
        # frame t shows the window at (oy - py*t, ox - px*t)
        oy, ox = (mh if py > 0 else 0), (mw if px > 0 else 0)
    fdir = os.path.join(root, "frames")
    os.makedirs(fdir)
    lines = []
    for t in range(n_frames):
        if pan:
            y_t, x_t = oy - py * t, ox - px * t
            frame = bg[y_t:y_t + h, x_t:x_t + w].copy()
        else:
            frame = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        for j in range(n_real):
            x = float(np.clip(x0[j] + (vx[j] + px) * t, 0,
                              w - widths[j] - 1))
            y = float(np.clip(y0[j] + py * t, 0, h - heights[j] - 1))
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


def launch_split(fn, reps=5):
    """[name, device ms] of each CUDA kernel launch of one fn() call, in
    launch order: one call traced by torch.profiler at a time, after one
    untraced call, and the median over the `reps` traces that caught the
    most launches (a trace can miss a short kernel's record)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traces.append(sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start))
    n = max(len(t) for t in traces)
    full = [t for t in traces if len(t) == n]
    return [[full[0][i].name[:90], statistics.median(
        t[i].time_range.elapsed_us() / 1e3 for t in full)]
        for i in range(n)]


def scratch_bytes(fn):
    """Device memory that one fn() call allocates beside its result (the
    caching allocator's peak over the call, less the result's blocks)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base  # the result's blocks
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak - kept


def k2_launch_bytes(names, b, h, w, cin, cout, mip, down, esize):
    """The bytes that each of K2's launches `names` (one call's, in launch
    order, as `launch_split` saw them) must move: its inputs read once and
    its outputs written once, the per-channel vectors left out. The GEMM
    launches are conv1, conv2 and the down GEMM in that order; conv1
    writes y1 in f32 and the partial sums where an IBN pass follows it."""
    from reid_tpu_torch.ops import qblock
    m = b * h * w
    part = 4 * b * len(qblock.tile_segments(h, w, cout)) * cout
    gate = 4 * b * cout
    y1 = any("ibn_apply_kernel" in n for n in names)
    per_kernel = {
        "quant_kernel": esize * m * cin + m * cin * (2 if down else 1),
        "ibn_apply_kernel": 2 * part + 5 * m * cout,
        "se_gate_kernel": part + 4 * cout * mip + gate,
        "resid_kernel": 4 * m * cout + gate + 2 * esize * m * cout}
    gemms = iter([
        m * cin + 9 * cin * cout + (2 * part + 4 * m * cout if y1
                                    else m * cout),
        m * cout + 9 * cout * cout + part + 4 * m * cout,
        m * cin + cin * cout + 4 * m * cout + gate + esize * m * cout])
    out = []
    for name in names:
        key = next((k for k in per_kernel if k in name), None)
        out.append(per_kernel[key] if key else next(gemms))
    return out


def plain_one_part(x, p, ibn, dtype):
    """The fused block's plain version with each image summed in one set of
    8 stripes over all its rows, as before an image's rows were split
    across tiles: the order that `moved_by_tile_order` compares with."""
    import torch
    from reid_tpu_torch.ops import qblock
    from reid_tpu_torch.ops.qconv import conv_acc_plain, quantize_s8

    def mean(v):
        b, h, w, c = v.shape
        rows = v.reshape(b, h * w, c)
        acc = rows.new_zeros((b, 8, c))
        for r0 in range(0, h * w, 8):
            part = rows[:, r0:r0 + 8]
            acc[:, :part.shape[1]] += part
        total = acc[:, 0]
        for s in range(1, 8):
            total = total + acc[:, s]
        return (total / (h * w))[:, None, None, :]

    cout = p.w2.shape[0]
    acc1 = conv_acc_plain(quantize_s8(x, p.inv_sx1), p.w1, 3)
    if ibn:
        y1 = acc1 * p.dq1_vec
        mu = mean(y1)
        var = torch.clamp(mean(y1 * y1) - mu * mu, min=0.0)
        y_in = (y1 - mu) * (1.0 / torch.sqrt(var + 1e-5)) * p.in_scale \
            + p.in_bias
        ch = torch.arange(cout, device=x.device)
        h1 = torch.relu(torch.where(ch < cout // 2, y_in,
                                    y1 * p.a1 + p.c1))
    else:
        h1 = torch.relu(acc1 * p.a1 + p.c1)
    y2 = conv_acc_plain(quantize_s8(h1, p.inv_sx2), p.w2, 3) * p.a2 + p.c2
    s = qblock._fc_warp(mean(y2)[:, 0, 0, :].to(torch.bfloat16).float(),
                        p.wfc1.float())
    s = torch.relu(s.to(torch.bfloat16)).float()
    gate = torch.reciprocal(1.0 + torch.exp(-qblock._fc_serial(
        s, p.wfc2.float())))
    if p.wd is not None:
        branch = conv_acc_plain(quantize_s8(x, p.inv_sxd), p.wd, 1) * p.ad \
            + p.cd
    else:
        branch = x.to(torch.float32)
    return torch.relu(y2 * gate[:, None, None, :] + branch).to(dtype)


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
                gmc_s=pipe.timing["gmc"], device_kernel_ms=busy_ms,
                launches=counts,
                site_launches={f"{n} {list(s)}": c
                               for (n, s), c in sites.items()},
                affines=np.asarray(pipe.affines))


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
    chunked.pop("affines")
    emit("track chunked", chunk=chunk, **chunked)
    step = run_track(base + ["--chunk", "1", "--max_frames", str(step_frames),
                             "--save_txt", os.path.join(tmp, "step.txt")],
                     trace("step"))
    step.pop("affines")
    emit("track step", **step)
    for run, name in ((chunked, "chunked"), (step, "step")):
        assert run["rows"] > 0 and run["distinct_ids"] >= 40, (name, run)
        for k in ("conv3x3_s8", "se_basic_block_s8"):
            assert run["launches"].get(k, 0) > 0, (name, k, run["launches"])
    # the default bf16 embed (cuDNN convolutions): no int8 kernel runs
    bf16 = run_track([a for a in base if a != "--int8"]
                     + ["--chunk", str(chunk), "--save_txt",
                        os.path.join(tmp, "chunk_bf16.txt")])
    bf16.pop("affines")
    emit("track chunked bf16", chunk=chunk, **bf16)
    assert bf16["rows"] > 0 and bf16["distinct_ids"] >= 40, bf16
    assert not bf16["launches"], bf16["launches"]
    return chunked, step


def phase_gmc(tmp, n_frames, chunk, step_frames):
    """botsort with camera-motion compensation on a scene panned by PAN px
    a frame: `--chunk` with the device estimator, then the step path
    (per-frame `estimate_affine` on the host). The chunked affines must
    recover the pan within 1 px and equal the CPU's
    `chunk_affines_translation` of the same frames within 1e-3 px; the
    step path's within 1 px of the pan."""
    import torch
    from reid_tpu_torch.tracking import gmc
    from reid_tpu_torch.tracking.gmc import chunk_affines_translation
    from reid_tpu_torch.tracking.sources import iter_frames

    fdir, det = write_scene(tmp, n_frames, pan=PAN)
    base = ["--detections", det, "--frames_dir", fdir, "--int8",
            "--max_dets", "64", "--num_classes", "751", "--crop_hw", "256",
            "128", "--tracking_method", "botsort"]
    chunk_argv = base + ["--chunk", str(chunk), "--save_txt",
                         os.path.join(tmp, "botsort_chunk.txt")]
    chunked = run_track(chunk_argv)
    # the same run again: cuFFT loaded and its plans made
    again = run_track(chunk_argv)
    again.pop("affines")
    step = run_track(base + ["--chunk", "1", "--max_frames", str(step_frames),
                             "--save_txt",
                             os.path.join(tmp, "botsort_step.txt")])
    aff_c, aff_s = chunked.pop("affines"), step.pop("affines")
    frames = torch.from_numpy(np.stack([f for _, f in iter_frames(fdir)]))
    cpu = np.concatenate([chunk_affines_translation(
        frames[s - 1] if s else frames[0], frames[s:s + chunk]).numpy()
        for s in range(0, n_frames, chunk)])
    pan = np.asarray(PAN, np.float32)
    eye = np.eye(2, dtype=np.float32)
    # the estimator alone on a warm card: one 32-frame chunk
    dev_frames = frames[:chunk + 1].cuda()
    warm_ms = time_ms(lambda: chunk_affines_translation(dev_frames[0],
                                                        dev_frames[1:]))
    del dev_frames
    res = dict(
        pan=list(PAN), cv2=gmc._HAS_CV2,
        chunk_max_err_to_pan=float(np.abs(aff_c[1:, :, 2] - pan).max()),
        chunk_max_err_to_cpu=float(np.abs(aff_c[:, :, 2]
                                          - cpu[:, :, 2]).max()),
        chunk_linear_is_identity=bool((aff_c[:, :, :2] == eye).all()),
        step_max_err_to_pan=float(np.abs(aff_s[1:, :, 2] - pan).max()),
        gmc_ms_per_chunk=1e3 * chunked["gmc_s"] * chunk / n_frames,
        gmc_ms_per_chunk_again=1e3 * again["gmc_s"] * chunk / n_frames,
        fps_again=again["fps"],
        gmc_ms_per_chunk_warm=warm_ms,
        step_gmc_ms_per_frame=1e3 * step["gmc_s"] / step_frames)
    emit("track botsort chunked", chunk=chunk, **chunked)
    emit("track botsort step", **step)
    emit("gmc", **res)
    assert res["chunk_max_err_to_pan"] <= 1.0, res
    assert res["chunk_max_err_to_cpu"] <= 1e-3, res
    assert res["chunk_linear_is_identity"], res
    assert res["step_max_err_to_pan"] <= 1.0, res
    for run, name in ((chunked, "chunked"), (step, "step")):
        assert run["rows"] > 0 and run["distinct_ids"] >= 40, (name, run)
        for k in ("conv3x3_s8", "se_basic_block_s8"):
            assert run["launches"].get(k, 0) > 0, (name, k, run["launches"])
    return res


def phase_probe(kind):
    """The qconv probe (`reid_tpu_torch.qconv_probe.run`) at its four
    configurations, the path of K3-K5: launch counts zeroed just before
    and read just after. Every kernel row must be exact against its plain
    version and K1. Returns the kernel rows and the path's counts."""
    import torch
    from reid_tpu_torch import qconv_probe
    from reid_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        results = qconv_probe.run()
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    emit("qconv probe", wall_s=time.perf_counter() - t0, launches=counts,
         configs=results)
    rows = []
    for res in results:
        for row in res["rows"]:
            if "kernel" not in row:
                continue
            assert row["exact"] and row["equals_k1"] and row["plain_exact"], \
                (res["config"], row)
            name = row["kernel"]
            k1 = name == "conv3x3_s8"
            assert row["launches_per_call"] == 1, (res["config"], row)
            rows.append(dict(
                name=f"{name} probe {res['config']}", route="cuda",
                source=K1_SOURCE if k1 else VARIANT_SOURCE,
                replaces=K1_REPLACES if k1 else VARIANT_REPLACES[name],
                path="qconv probe", shape=res["shape"],
                before_ms=VARIANT_BEFORE_MS.get(name, {}).get(res["config"]),
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "tops", "x_bf16",
                                       "launches_per_call")}))
    for name in ("conv3x3_s8",) + tuple(VARIANT_REPLACES):
        assert counts.get(name, 0) > 0, (name, counts)
    return rows, counts


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


class Split:
    """Labels, cameras and sequences of a subset of a split."""

    def __init__(self, ds, rows):
        self.labels, self.cams, self.seqs = (ds.labels[rows], ds.cams[rows],
                                             ds.seqs[rows])


def market_splits():
    """Query and gallery of Market-1501's size, made by the port's
    `synthetic_dataset` (the two splits in two threads) with one palette,
    so that ids match across the splits. Each identity's copies cycle over
    the 6 cameras, the queries' 3 cameras after the gallery's."""
    from concurrent.futures import ThreadPoolExecutor

    from reid_tpu_torch.data import synthetic_dataset

    def make(n, seed, shift):
        ds = synthetic_dataset(n, num_pids=N_IDS, height=256, width=128,
                               num_cams=N_CAMS, seed=seed, palette_seed=0)
        ds.records = [(p, pid, (i // N_IDS + shift) % N_CAMS, 0)
                      for i, (p, pid, _, _) in enumerate(ds.records)]
        return ds

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        query, gallery = pool.map(lambda a: make(*a), ((N_QUERY, 1, 3),
                                                       (N_GALLERY, 2, 0)))
    return query, gallery, time.perf_counter() - t0


def phase_retrieval(query, gallery, make_s, profile_to=None, int8=False):
    """The retrieval path once, at the operating point (with `int8`, its
    `--int8` serving embed), with the launch counts zeroed just before and
    read just after; traced with torch.profiler when `profile_to` names a
    file."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.ops import _lib

    argv = ["--search_option", "dense", "--bs", "64"] + (
        ["--int8"] if int8 else [])
    timing, keep = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    def run():
        return cli.inference(argv, device="cuda",
                             splits=(query, gallery, N_CLASSES),
                             timing=timing, keep=keep)

    t0 = time.perf_counter()
    busy_ms = None
    if profile_to:
        (cmc, mean_ap), busy_ms = profiled(run, profile_to)
    else:
        cmc, mean_ap = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    sites = {f"{n} {list(s)}": c
             for (n, s), c in _lib.site_launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    dists = keep.pop("dists")
    n = N_QUERY + N_GALLERY
    dim = keep["qf"].shape[1]
    emit("retrieval --int8" if int8 else "retrieval", n_query=N_QUERY,
         n_gallery=N_GALLERY, dim=dim, cmc1=float(cmc[0]),
         cmc5=float(cmc[4]), cmc10=float(cmc[9]), mAP=mean_ap,
         stage_s=timing, wall_s=wall, data_s=make_s, peak_mem_gb=peak / 1e9,
         device_kernel_ms=busy_ms, launches=counts, site_launches=sites)
    assert dim == 512 + N_CLASSES and tuple(dists.shape) == (n, n)
    assert bool(torch.isfinite(dists).all()) and float(dists.min()) >= 0.0
    assert np.all(np.isfinite(cmc)) and np.all(np.diff(cmc) >= 0)
    assert 0.0 < mean_ap <= 1.0 and cmc[-1] <= 1.0
    for k in ("sqeuclidean", "l1") + (
            ("conv3x3_s8", "se_basic_block_s8") if int8 else ()):
        assert counts.get(k, 0) > 0, (k, counts)
    del dists
    return keep, counts, sites


def retrieval_batch(query, gallery, dev):
    """The `--int8` retrieval trunk's calibration batch (the first 32
    gallery images and their flips, as `cli.inference` calibrates) and one
    embed batch (--bs 64 query images and their flips: 128)."""
    import torch
    from reid_tpu_torch.data.transforms import inference_batch

    def both(split, k):
        x = inference_batch(torch.from_numpy(
            split.gather(np.arange(k))["images"]).to(dev))
        return torch.cat([x, torch.flip(x, dims=(2,))])
    return both(gallery, 32), both(query, 64)


def phase_distance_kernels(kind, keep):
    """K6 and K7 against their plain versions on the operands the first
    Jaccard call gave them, timed beside the plain version, the bound and
    torch.cdist: the run's de-biased unit features (K6), and the V encoding
    recomputed from them and their ranking (K7)."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.ops import distance as dist
    from reid_tpu_torch.ops import rerank
    from reid_tpu_torch.ops.camera import diminish_camera_bias
    from reid_tpu_torch.utils.timing import StageTimer

    rows = []
    with full_f32(), torch.inference_mode():
        # K6: one query block of the first Jaccard's initial ranking
        cams = torch.cat([torch.as_tensor(keep["gallery_cams"]),
                          torch.as_tensor(keep["query_cams"])]).cuda()
        feats = diminish_camera_bias(torch.cat([keep["gf"], keep["qf"]]),
                                     cams)
        feats = (feats / feats.norm(dim=1, keepdim=True)).contiguous()
        x = feats[:1024]
        m, d = x.shape
        n = feats.shape[0]
        got = dist.sqeuclidean(x, feats)
        want = dist.sqeuclidean_plain(x, feats)
        torch.cuda.synchronize()
        err = (got - want).abs()
        assert bool((err <= 1e-4 + 1e-4 * want.abs()).all()), err.max()
        top_g = torch.sort(got, dim=1, stable=True).indices[:, :20]
        top_w = torch.sort(want, dim=1, stable=True).indices[:, :20]
        topk_share = (top_g == top_w).all(1).double().mean().item()
        self_first = (top_g[:, 0] == torch.arange(m, device="cuda")).double()\
            .mean().item()
        del got, want, top_g, top_w
        bms, by = bound(2 * m * n * d, 4 * (m * d + n * d + m * n), kind,
                        "fp32")
        rows.append(dict(
            name="sqeuclidean topk block", route="cuda", source=DIST_SOURCE,
            replaces=K6_REPLACES, site=[m, n, d], path="retrieval",
            max_abs_err=err.max().item(), top20_rows_equal=topk_share,
            self_first=self_first,
            ms=time_ms(lambda: dist.sqeuclidean(x, feats)),
            plain_ms=time_ms(lambda: dist.sqeuclidean_plain(x, feats)),
            library_ms=time_ms(lambda: torch.cdist(x, feats)),
            bound_ms=bms, bound_by=by))
        rows[-1]["queued_ms"], rows[-1]["host_ms"] = time_queued_ms(
            lambda: dist.sqeuclidean(x, feats))
        rows[-1]["library_queued_ms"], _ = time_queued_ms(
            lambda: torch.cdist(x, feats))
        # the row norms, the transposed copies and the tile kernel apart
        rows[-1]["device_split_ms"] = launch_split(
            lambda: dist.sqeuclidean(x, feats))
        del err, x
        emit(f"kernel {rows[-1]['name']}", **rows[-1])

        # K7: a 1,024-row slab of the min-sum, then one full call
        _, rank = dist.topk_neighbors(feats, feats, k=20)
        v = rerank._v_encoding(feats, rank, 20, 6, StageTimer(None, "cuda"))
        del feats, rank
        nnz = (v > 0).sum(1)
        slab = v[:1024]
        m, (n, d) = slab.shape[0], v.shape
        got = dist.l1(slab, v)
        want = dist.l1_plain(slab, v)
        torch.cuda.synchronize()
        err = (got - want).abs()
        assert bool((err <= 1e-5 + 1e-5 * want.abs()).all()), err.max()
        del got, want
        bms, by = bound(2 * m * n * d, 4 * (m * d + n * d + m * n), kind,
                        "fp32_alu")
        row = dict(
            name="l1 min-sum slab", route="cuda", source=DIST_SOURCE,
            replaces=K7_REPLACES, site=[m, n, d], path="retrieval",
            v_nonzeros_per_row_mean=nnz.double().mean().item(),
            v_nonzeros_per_row_max=int(nnz.max()),
            max_abs_err=err.max().item(),
            ms=time_ms(lambda: dist.l1(slab, v)),
            plain_ms=time_ms(lambda: dist.l1_plain(slab, v), reps=2, warm=1),
            library_ms=time_ms(lambda: torch.cdist(slab, v, p=1), reps=2,
                               warm=1),
            bound_ms=bms, bound_by=by)
        del err, nnz
        row["full_ms"] = time_ms(lambda: dist.l1(v, v), reps=1, warm=0)
        # one call, about 20 s
        row["full_library_ms"] = time_ms(lambda: torch.cdist(v, v, p=1),
                                         reps=1, warm=0)
        row["full_bound_ms"], _ = bound(2 * n * n * d,
                                        4 * (2 * n * d + n * n), kind,
                                        "fp32_alu")
        rows.append(row)
        del v, slab
        emit(f"kernel {row['name']}", **row)
    torch.cuda.empty_cache()
    return rows


def phase_retrieval_cpu(keep, query, gallery):
    """The post-embed half on the card (kernels) and on the CPU (plain
    versions), on the same 1,024 features (ids 0-31), dense and sparse.

    Near-ties in the top-k ranking make this comparison chaotic where it
    is not a test of arithmetic: a pair of neighbours whose distances lie
    within rounding of each other can swap places, which moves them across
    the k1/2 + 1 and k2 cuts and changes whole rows of J, and DBSCAN plus
    smoothing pull each cluster's embeddings together (0.9 x the mean), so
    the second Jaccard meets ten times closer ties. So the end-to-end
    results are held loosely (CMC within 1/Q at every rank, mAP within
    1e-2) and the share of J entries within 1e-4 is reported without a
    limit, and the arithmetic is held tightly on its own: from the same
    de-biased features and the same ranking, the card's Jaccard equals the
    CPU's within 1e-5 everywhere, and the two rankings hold the same
    top-20 sets on >= 99.9% of rows."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config, RetrievalConfig
    from reid_tpu_torch.eval.inference import evaluate_features
    from reid_tpu_torch.ops import _lib, rerank
    from reid_tpu_torch.ops.camera import diminish_camera_bias
    from reid_tpu_torch.ops.distance import topk_neighbors

    qr = np.flatnonzero(query.labels < 32)
    gr = np.flatnonzero(gallery.labels < 32)
    qf, gf = keep["qf"][qr].cpu(), keep["gf"][gr].cpu()
    q, g = Split(query, qr), Split(gallery, gr)
    out = {}
    for option in ("dense", "sparse"):
        cfg = Config(retrieval=RetrievalConfig(search_option=option))
        res = []
        for dev in ("cuda", "cpu", "cuda"):
            k = {}
            t0 = time.perf_counter()
            _lib.reset_launch_counts()
            with full_f32(), torch.inference_mode():
                cmc, mean_ap = evaluate_features(
                    qf.to(dev), gf.to(dev), q, g, cfg, verbose=False, keep=k)
            res.append((cmc, mean_ap, k["dists"].cpu(),
                        time.perf_counter() - t0, _lib.launch_counts()))
        (cmc_g, map_g, j_g, s_g, n_g), (cmc_c, map_c, j_c, s_c, n_c), \
            (cmc_r, map_r, j_r, _, _) = res
        err = (j_g - j_c).abs()
        # the card repeats itself bit for bit
        repeat = bool(torch.equal(j_g, j_r) and np.array_equal(cmc_g, cmc_r)
                      and map_g == map_r)
        out[option] = dict(rows=len(qr) + len(gr),
                           share_within_1e4=(err <= 1e-4).double().mean()
                           .item(), max_abs_err=err.max().item(),
                           cmc_max_diff=float(np.abs(cmc_g - cmc_c).max()),
                           mAP_card=map_g, mAP_cpu=map_c, card_s=s_g,
                           cpu_s=s_c, card_launches=n_g,
                           card_repeat_bit_equal=repeat)
        assert not n_c and n_g.get("sqeuclidean", 0) > 0, (n_c, n_g)
        assert repeat, out[option]
        assert out[option]["cmc_max_diff"] <= 1.0 / len(qr) + 1e-6
        assert abs(map_g - map_c) <= 1e-2, out[option]

    # the arithmetic alone: same features, same ranking
    with full_f32(), torch.inference_mode():
        cams = torch.as_tensor(np.concatenate([g.cams, q.cams]))
        x = diminish_camera_bias(torch.cat([gf, qf]), cams)
        x = x / x.norm(dim=1, keepdim=True)
        _, r_c = topk_neighbors(x, x, k=20)
        _, r_g = topk_neighbors(x.cuda(), x.cuda(), k=20)
        r_g = r_g.cpu()
        same = {"order": (r_g == r_c).all(1).double().mean().item(),
                "set": (torch.sort(r_g, 1).values == torch.sort(r_c, 1).values
                        ).all(1).double().mean().item()}
        for s in (None, 512):
            j_g = rerank._jaccard_from_rank(x.cuda(), r_c.cuda(), 20, 6,
                                            sparse_s=s).cpu()
            j_c = rerank._jaccard_from_rank(x, r_c, 20, 6, sparse_s=s)
            same[f"jaccard_max_abs_err_s{s}"] = (j_g - j_c).abs().max().item()
            assert same[f"jaccard_max_abs_err_s{s}"] <= 1e-5, same
    assert same["set"] >= 0.999, same
    emit("retrieval vs cpu", **out, same_ranking=same)
    return out


def phase_embed_retrieval(query):
    """The f32 and the int8 TTA serving embed of the retrieval path, card
    against CPU, on 16 query images: the same weights and, for int8, the
    same QuantState."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             make_embed_fn,
                                             make_int8_embed_fn)
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import QuantState

    imgs = torch.from_numpy(query.gather(np.arange(16))["images"])
    res = {}
    with full_f32(), torch.inference_mode():
        cpu = build_model("seres18", num_classes=N_CLASSES, device="cpu")
        card = build_model("seres18", num_classes=N_CLASSES, device="cuda")
        card.load_state_dict(cpu.state_dict())
        qs = calibrate_serving_qstate(cpu, imgs)
        qs_card = QuantState({k: v.cuda() for k, v in qs.kernels.items()},
                             {k: v.cuda() for k, v in qs.w_scales.items()},
                             qs.act_scales)
        for name, f_cpu, f_card, lim in (
                ("f32", make_embed_fn(cpu), make_embed_fn(card), 0.99999),
                ("int8", make_int8_embed_fn(cpu, qstate=qs),
                 make_int8_embed_fn(card, qstate=qs_card), 0.999)):
            e_c = f_cpu(imgs.float())
            e_g = f_card(imgs.float().cuda()).cpu()
            cos = (e_c * e_g).sum(1) / (e_c.norm(dim=1) * e_g.norm(dim=1))
            res[name] = dict(min_cosine=cos.min().item(), threshold=lim)
            assert cos.min().item() >= lim, (name, cos)
    emit("embed retrieval", images=16, **res)


@contextlib.contextmanager
def timed_detector(calls):
    """While active, the CLI's built-in detector is wrapped: each call
    appends (seconds between device synchronisations, valid
    detections)."""
    import torch
    from reid_tpu_torch import cli

    build = cli.build_detector

    def wrapped(*a, **kw):
        detect = build(*a, **kw)

        def timed(frame):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = detect(frame)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0, int(out[2].sum())))
            return out
        return timed

    cli.build_detector = wrapped
    try:
        yield
    finally:
        cli.build_detector = build


def frame_boxes(cand, scale, pad):
    """Candidates (N, 6) cx, cy, w, h in letterbox pixels -> tlwh (N, 4)
    in frame pixels, as the detector undoes the letterbox."""
    import torch
    from reid_tpu_torch.models.yolo import inv_f32
    tl = cand[:, :2] - 0.5 * cand[:, 2:4]
    tlwh = torch.cat([tl, cand[:, 2:4]], dim=1)
    shift = torch.tensor([pad[1], pad[0], 0.0, 0.0], device=cand.device)
    return ((tlwh - shift) * inv_f32(scale)).cpu().numpy()


def phase_detector_card_vs_cpu(argv, frames, kind, launches):
    """The YOLOv5s int8 detector of `argv` built as the CLI builds it
    (seed 1, calibrated on the source's first 8 frames), on the card and,
    with the same weights and QuantState, on the CPU (the plain kernel
    versions), on `frames`: valid counts equal, and every card box within
    0.5 px of the CPU's box of the same candidate (anchor cell). The share
    of boxes within 0.02 px and of output slots that hold the same box are
    reported, with the head maps' largest difference against their
    largest value and cosine. Then one frame's device launches and device
    time (torch.profiler) beside its time, `nms_fixed` alone on the card,
    and K1 at DET_K1_SITES on the first frame's inputs (exact against its
    plain version, timed). Returns the K1 rows."""
    import copy

    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.models import yolo
    from reid_tpu_torch.utils.quantize import (QuantState, quantize_input,
                                               quantized_model)

    args = cli._parser().parse_args(argv)
    det_hw = tuple(args.det_size)
    rows, res = [], dict(frames=len(frames))
    with torch.inference_mode(), cli.full_f32():
        model, qs = cli.build_yolo_detector(args, "cuda")
        cpu_model = copy.deepcopy(model).cpu()
        cpu_qs = QuantState({k: v.cpu() for k, v in qs.kernels.items()},
                            {k: v.cpu() for k, v in qs.w_scales.items()},
                            dict(qs.act_scales))
        kw = dict(max_dets=args.max_dets, conf_thres=args.conf_thres)
        keep_g, keep_c = {}, {}
        det_g = yolo.make_yolo_detector_fn(model, det_hw, qstate=qs,
                                           keep=keep_g, **kw)
        det_c = yolo.make_yolo_detector_fn(cpu_model, det_hw, qstate=cpu_qs,
                                           keep=keep_c, **kw)
        per = []
        for frame in frames:
            tg, cg, vg = det_g(frame)
            tc, cc, vc = det_c(frame)
            scale, _, pad = yolo.letterbox_geometry(frame.shape[:2], det_hw)
            cand_g = frame_boxes(keep_g["candidates"][0], scale, pad)
            cand_c = frame_boxes(keep_c["candidates"][0], scale, pad)
            # each card box's candidate, and the CPU's box of it
            errs = []
            for box in tg[vg]:
                j = int(np.abs(cand_g - box).max(1).argmin())
                assert np.abs(cand_g[j] - box).max() < 1e-3, box
                errs.append(float(np.abs(cand_c[j] - box).max()))
            errs = np.asarray(errs)
            same_slot = (vg == vc) & (np.abs(tg - tc).max(1) <= 0.02)
            heads = []
            for a, b in zip(keep_g["preds"], keep_c["preds"]):
                a, b = a.float().cpu().double(), b.float().double()
                heads.append(dict(
                    max_err_over_max=((a - b).abs().max()
                                      / b.abs().max()).item(),
                    cosine=((a * b).sum() / (a.norm() * b.norm())).item()))
            per.append(dict(valid_card=int(vg.sum()), valid_cpu=int(vc.sum()),
                            max_box_err_px=float(errs.max(initial=0.0)),
                            share_within_0_02px=float(
                                (errs <= 0.02).mean()) if len(errs) else 1.0,
                            share_slots_equal=float(same_slot[vg].mean())
                            if vg.any() else 1.0,
                            heads=heads))
        res["per_frame"] = per
        res["nms_rounds_per_frame"] = keep_g["rounds"] / len(frames)
        # nms_fixed alone on the card, on the last frame's candidates: each
        # round ends on a host read of its exit test
        xywh, sc, cl = yolo.decode_yolo(keep_g["preds"])
        res["nms_ms"] = time_ms(lambda: yolo.nms_fixed(
            xywh[0], sc[0], cl[0], conf_thres=args.conf_thres,
            max_dets=args.max_dets))
        # K1 at the detector's call sites, on the first frame's inputs
        net = quantized_model(model, qs)
        seen = {}
        hooks = [net.get_submodule(
            p.replace("/", ".")).register_forward_pre_hook(
                lambda m, a, p=p: seen.__setitem__(p, a[0]))
            for p, _ in DET_K1_SITES]
        fr = torch.as_tensor(frames[0]).cuda()
        net(yolo.letterbox(fr[None], det_hw))
        for h in hooks:
            h.remove()
        for path, (h, w, cin, cout) in DET_K1_SITES:
            mod = net.get_submodule(path.replace("/", "."))
            assert mod.route, path
            xq = quantize_input(seen[path], mod.sx).contiguous()
            assert tuple(xq.shape) == (1, h, w, cin), xq.shape
            row, _ = k1_row(kind, mod, xq, torch.bfloat16,
                            f"conv3x3_s8 {path} 1x{h}x{w} c{cin}",
                            "track --detector yolov5 --int8")
            row["launches"] = launches[(h, w, cin, cout)]
            rows.append(row)
        # one frame's time, then its device launches and their summed device
        # time (torch.profiler; traced last, as a trace slows later calls)
        res["host_clock_ms_per_frame"] = time_ms(lambda: det_g(frames[0]),
                                                 reps=5, warm=1)
        split = launch_split(lambda: det_g(frames[0]))
        res["launches_per_frame"] = len(split)
        res["device_ms_per_frame"] = sum(k[1] for k in split)
    emit("yolov5 card vs cpu", **res)
    for f in per:
        assert f["valid_card"] == f["valid_cpu"], per
        assert f["max_box_err_px"] <= 0.5, per
    return rows


def phase_track_yolo(tmp, kind, n_frames=16):
    """`track` with the built-in YOLOv5s detector in int8 (DET_ARGS) on
    phase 4's scene, the step path over `n_frames` frames: fps, per-frame
    ms of the detector (timed around it, the device synchronised), of
    crop_embed and associate, valid detections a frame and K1's launches
    at the detector's sites (DET_K1_PER_FRAME a frame, exactly); then the
    detector card against CPU on 2 frames. Returns the K1 rows."""
    from reid_tpu_torch.tracking.sources import iter_frames

    fdir, _ = write_scene(tmp, n_frames)
    argv = ["--source", fdir, *DET_ARGS, "--save_txt",
            os.path.join(tmp, "yolo.txt")]
    calls = []
    with timed_detector(calls):
        run = run_track(argv)
    run.pop("affines")
    k1 = {s: run["site_launches"].get(f"conv3x3_s8 {list(s)}", 0)
          for s in DET_K1_PER_FRAME}
    t = run["timing_ms_per_frame"]
    emit("track yolov5 int8",
         detect_ms_per_frame=1e3 * sum(c[0] for c in calls) / len(calls),
         crop_embed_ms_per_frame=t["crop_embed"],
         associate_ms_per_frame=t["associate"],
         valid_detections_per_frame=sum(c[1] for c in calls) / len(calls),
         k1_detector_launches={str(list(s)): n for s, n in k1.items()},
         **run)
    assert len(calls) == n_frames == run["frames"], (len(calls), run)
    assert all(c[1] > 0 for c in calls), calls
    for s, per_frame in DET_K1_PER_FRAME.items():
        assert k1[s] == per_frame * n_frames, (s, k1)
    frames = [f for i, f in iter_frames(fdir) if i in (1, n_frames // 2 + 1)]
    return phase_detector_card_vs_cpu(argv, frames, kind, k1)


def phase_track_centernet(tmp, n_frames=8):
    """`track` with the built-in CenterNetLite (f32, no kernel of ours) on
    phase 4's scene, the step path over `n_frames` frames: fps and valid
    detections a frame."""
    fdir, _ = write_scene(tmp, n_frames)
    calls = []
    with timed_detector(calls):
        run = run_track(["--source", fdir, "--detector", "centernet",
                         "--conf_thres", "0.1", "--max_dets", "64",
                         "--num_classes", "751", "--crop_hw", "256", "128",
                         "--save_txt", os.path.join(tmp, "centernet.txt")])
    run.pop("affines")
    emit("track centernet", detect_ms_per_frame=1e3 * sum(
        c[0] for c in calls) / len(calls),
         valid_detections_per_frame=sum(c[1] for c in calls) / len(calls),
         **run)
    assert len(calls) == n_frames == run["frames"], run
    assert not run["launches"], run["launches"]


def phase_gauntlet():
    """`reid_tpu_torch.gauntlet`: its 300-frame scene rendered into a
    temporary directory, the five methods through `track_main --gt` on the
    card; each method's MOTA, IDF1 and HOTA inside its CHECK_BANDS."""
    from reid_tpu_torch import gauntlet

    t0 = time.perf_counter()
    results = gauntlet.run(device="cuda")
    for method, m in results.items():
        emit(f"gauntlet {method}", MOTA=m["MOTA"], IDF1=m["IDF1"],
             HOTA=m["HOTA"], IDSW=m["IDSW"], band=gauntlet.CHECK_BANDS[method],
             seconds=m["seconds"])
    bad = gauntlet.band_failures(results)
    emit("gauntlet", methods=list(results), outside_band=bad,
         seconds=time.perf_counter() - t0)
    assert not bad, bad


def set_launches(rows, sites):
    """Each K1/K2 row's launches at its call site in one run of its path."""
    for row in rows:
        kname = row["name"].split()[0]
        row["launches"] = sites.get(f"{kname} {row['site']}", 0)
        assert row["launches"] > 0, row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace both track runs and the retrieval run with "
                         "torch.profiler into chiprun_out/profile_{chunked,"
                         "step,retrieval}.txt")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from reid_tpu_torch.cli import full_f32

    smi, kind = phase_device()
    phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    crops = torch.randn((2048, 256, 128, 3), generator=gen, device=dev)
    rows = phase_kernels(kind, torch.bfloat16, crops[:32], crops, "track",
                         variants=True)
    del crops
    torch.cuda.empty_cache()
    probe_rows, probe_counts = phase_probe(kind)
    with tempfile.TemporaryDirectory() as tmp:
        chunked, _ = phase_track(tmp, 64, 32, 8, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        phase_gmc(tmp, 64, 32, 8)
    with tempfile.TemporaryDirectory() as tmp:
        det_rows = phase_track_yolo(tmp, kind)
    with tempfile.TemporaryDirectory() as tmp:
        phase_track_centernet(tmp)
    phase_gauntlet()
    phase_embed()
    # K1/K2 launches at their call sites on the track path; K3-K5 (here and
    # in the probe's rows) and K1's probe rows: the probe path's launches
    track_rows = [r for r in rows if r["path"] == "track"]
    set_launches(track_rows, chunked["site_launches"])
    for row in [r for r in rows if r["path"] == "qconv probe"] + probe_rows:
        row["launches"] = probe_counts[row["name"].split()[0]]
    rows += probe_rows + det_rows

    query, gallery, make_s = market_splits()
    keep, counts, _ = phase_retrieval(
        query, gallery, make_s, os.path.join(OUT_DIR, "profile_retrieval.txt")
        if args.profile else None)
    keep.update(query_cams=query.cams, gallery_cams=gallery.cams)
    keep8, _, sites8 = phase_retrieval(query, gallery, make_s, int8=True)
    cos = (keep8["gf"] * keep["gf"]).sum(1) / (
        keep8["gf"].norm(dim=1) * keep["gf"].norm(dim=1))
    emit("retrieval int8 vs f32 embed", gallery_min_cosine=cos.min().item(),
         gallery_mean_cosine=cos.mean().item())
    del keep8, cos
    with full_f32():
        calib, batch = retrieval_batch(query, gallery, dev)
        rows8 = phase_kernels(kind, torch.float32, calib, batch,
                              "retrieval --int8", suffix=" f32")
    del calib, batch
    set_launches(rows8, sites8)
    rows += rows8
    dist_rows = phase_distance_kernels(kind, keep)
    for row in dist_rows:
        row["launches"] = counts.get(row["name"].split()[0], 0)
        assert row["launches"] > 0, row
    rows += dist_rows
    phase_retrieval_cpu(keep, query, gallery)
    del keep
    phase_embed_retrieval(query)
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
