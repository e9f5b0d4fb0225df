#!/usr/bin/env python3
"""A/B of two eager forms of `reid_tpu_torch` on one card, at the MOT16
load of `chip_smoke.py`'s phase 4 (1920x1080, 50 boxes in 64 slots, 128
track slots, 256x128 crops, SERes18 `--int8`, strongsort, greedy_rounds,
chunk 32, two chunks):

- "associate": the chunk's frame loop. `ChunkedTracker.associate` (one
  `device_loop` whose rounds take each frame's inputs with `index_select`
  and write its outputs into (S, T, ...) buffers with `index_copy`)
  against a Python loop over slices of the chunk's inputs whose outputs
  are stacked at the end (the form before).
- "grouped_acc": the int8 grouped route's convolution (OSNet's depthwise
  convolutions) over a chunk's crop + embed with `--backbone osnet`
  instead. `utils.quantize.grouped_acc` through the
  `reid_tpu_torch::conv2d_tf32` custom op against the same convolution
  under a `torch.backends.cudnn.flags` block (the form before).

Each pair runs A B B A `--reps` times, each run timed on the host's clock
with the device synchronised around it; both forms must give bit-equal
results. Prints one JSON line and, last, the card's name and power limit
(`nvidia-smi`); writes chiprun_out/ab_chunk_loop.json.

    python3 scripts/torch_ab_chunk_loop.py [--reps 5] [--device cpu]

(`--device cpu` rehearses it on the CPU, where its times mean nothing.)
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from reid_tpu_torch.cli import full_f32  # noqa: E402
from reid_tpu_torch.tracking.pipeline import make_chunked_tracker  # noqa
from reid_tpu_torch.tracking.tracker import Tracker, stack_states  # noqa
from reid_tpu_torch.utils import quantize  # noqa: E402

CHUNK, FRAMES = 32, 64


def associate_slices(tracker, states, tlwh, conf, feats, valid,
                     affines=None):
    """The frame loop before: slices of the chunk's inputs, the outputs
    stacked."""
    inputs = (tlwh, conf, feats, valid, affines)
    outs = []
    for i in range(tlwh.shape[1]):
        states, out = tracker._frame(states, lambda x, i=i: x[:, i],
                                     i % tracker.k_embed, *inputs)
        outs.append(out)
    return states, {k: torch.stack([o[k] for o in outs], dim=1)
                    for k in outs[0]}


def grouped_acc_flags(xq, wq, stride, padding, groups):
    """`grouped_acc` before: cuDNN's TF32 flag set by a `with` block."""
    dt = torch.float64 if xq.device.type == "cpu" else torch.float32
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                 deterministic=c.deterministic, allow_tf32=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).to(dt), wq.to(dt),
                       stride=stride, padding=padding, groups=groups)
    return acc.permute(0, 2, 3, 1).to(torch.float32)


def flat(out):
    """Every tensor of a nested result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    return [t for o in out for t in flat(o)]


def abba(forms, reps, dev):
    """Runs forms "a" and "b" (callables) A B B A `reps` times: the seconds
    of each run and whether their last outputs are bit-equal."""
    secs, last = {"a": [], "b": []}, {}
    for _ in range(reps):
        for name in "abba":
            chip_smoke.sync(dev)
            t0 = time.perf_counter()
            last[name] = forms[name]()
            chip_smoke.sync(dev)
            secs[name].append(time.perf_counter() - t0)
    equal = all(torch.equal(x, y) for x, y in zip(flat(last["a"]),
                                                  flat(last["b"])))
    return secs, equal


def summary(secs, per):
    return {k: {"median_ms": 1e3 * statistics.median(v) / per,
                "min_ms": 1e3 * min(v) / per, "max_ms": 1e3 * max(v) / per}
            for k, v in secs.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_ab_chunk_loop: no CUDA device")
    smi = chip_smoke.phase_device()[0] if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_scene(tmp, FRAMES)
        cfg, embed_fn, feat_dim, data = chip_smoke.chunk_run_inputs(
            chip_smoke.scene_argv(tmp, "--int8"), FRAMES, dev)
        cfg_o, embed_o, _, _ = chip_smoke.chunk_run_inputs(
            chip_smoke.scene_argv(tmp, "--int8", "--backbone", "osnet"), 1,
            dev)
    tracker = make_chunked_tracker(cfg, embed_fn, cfg.crop_hw, CHUNK)
    osnet = make_chunked_tracker(cfg_o, embed_o, cfg_o.crop_hw, CHUNK)
    chunks = [[x[i:i + CHUNK][None] for x in data]
              for i in range(0, FRAMES, CHUNK)]
    state0 = stack_states([Tracker(cfg, feat_dim, dev).init_state()])
    res = {"card": smi, "chunk": CHUNK, "frames": FRAMES, "reps": args.reps}
    with full_f32(), torch.inference_mode():
        embedded = [tracker.embed(frames, tlwh, conf, valid)
                    for frames, tlwh, conf, valid in chunks]

        def run(associate):
            def go():
                states, outs = state0, []
                for (_, tlwh, conf, _), (feats, valid) in zip(chunks,
                                                               embedded):
                    states, out = associate(states, tlwh, conf, feats,
                                            valid)
                    outs.append(out)
                return states, outs
            return go

        secs, equal = abba({
            "a": run(lambda *a: associate_slices(tracker, *a)),
            "b": run(tracker.associate)}, args.reps, dev)
        res["associate"] = dict(
            a="python loop over slices, outputs stacked",
            b="ChunkedTracker.associate (device_loop, index_select / "
              "index_copy)", ms_per_frame=summary(secs, FRAMES),
            bit_equal=equal)

        calls = [0]
        op_form = quantize.grouped_acc

        def counted(*a):
            calls[0] += 1
            return op_form(*a)

        frames, tlwh, conf, valid = chunks[0]

        def embed_with(form):
            def go():
                quantize.grouped_acc = form
                try:
                    return osnet.embed(frames, tlwh, conf, valid)
                finally:
                    quantize.grouped_acc = op_form
            return go

        embed_with(counted)()
        secs, equal = abba({"a": embed_with(grouped_acc_flags),
                            "b": embed_with(op_form)}, args.reps, dev)
        res["grouped_acc"] = dict(
            backbone="osnet", a="cudnn.flags block",
            b="conv2d_tf32 custom op",
            calls_per_embed=calls[0], boxes=int(valid.sum()),
            ms_per_chunk=summary(secs, 1), bit_equal=equal)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "ab_chunk_loop.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    assert res["associate"]["bit_equal"] and res["grouped_acc"]["bit_equal"]
    print(smi, flush=True)


if __name__ == "__main__":
    main()
