"""Per-shape probe of the int8 3x3 convolution kernels on the SERes18
trunk's layer shapes: the counterpart of `scripts/qconv_probe.py`.

For each configuration (the same `CONFIGS`, inputs from
`np.random.default_rng(0)` as there) it times the bf16 convolution
(`F.conv2d`, channels-last), the library int8 route (`torch._int_mm` on a
ready im2col, the counterpart of the JAX probe's `xla-i8`) and the four
hand-written kernels: K1 `roll` (`conv3x3_s8`), K3 `ncat`, K4 `bitshift`
and K5 `dma` (the JAX probe leaves `dma` out). Each row holds exactness
against the kernel's plain version and K1 (f32 out, unit scale), the median
ms by CUDA events, TOP/s, the speed against bf16, the plain version's ms,
the least time the card could take for the work (`utils.timing.bound`),
the kernel launches of the configuration and the device work that one
call launches (the nodes of a captured CUDA graph, after all the
timings). One JSON line per configuration.

    python -m reid_tpu_torch.qconv_probe            # on the card

`run(configs, device="cpu")` checks the plain versions against each other
and prints no time.
"""

from __future__ import annotations

import ctypes
import json
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops import _lib
from .ops import qconv as q

# (name, B, H, W, Cin, Cout): B = 512 crops (a realistic embed batch);
# stages at 32x16 / 16x8 after the stem of a 256x128 crop, 8x4 for 128x64
CONFIGS: List[Tuple[str, int, int, int, int, int]] = [
    ("stage2 32x16 c128", 512, 32, 16, 128, 128),
    ("stage3 16x8  c256", 512, 16, 8, 256, 256),
    ("stage4 16x8  c512", 512, 16, 8, 512, 512),
    ("fc-stage4 8x4 c512", 512, 8, 4, 512, 512),
]

# name -> (kernel(x, wt, wn, scale, out_dtype), plain(...), launch name)
KERNELS = {
    "roll": (lambda x, wt, wn, s, dt: q.conv3x3_s8(x, wt, s, dt),
             lambda x, wt, wn, s, dt: q.conv3x3_s8_plain(x, wt, s, dt),
             q.NAME),
    "ncat": (lambda x, wt, wn, s, dt: q.conv3x3_s8_ncat(x, wn, s, 0, dt),
             lambda x, wt, wn, s, dt: q.conv3x3_s8_ncat_plain(x, wn, s, dt),
             q.NCAT),
    "bitshift": (lambda x, wt, wn, s, dt: q.conv3x3_s8_bitshift(x, wt, s, dt),
                 lambda x, wt, wn, s, dt: q.conv3x3_s8_bitshift_plain(
                     x, wt, s, dt),
                 q.BITSHIFT),
    "dma": (lambda x, wt, wn, s, dt: q.conv3x3_s8_dma(x, wt, s, 0, dt),
            lambda x, wt, wn, s, dt: q.conv3x3_s8_dma_plain(x, wt, s, dt),
            q.DMA),
}


def make_inputs(rng: np.random.Generator, b, h, w, cin, cout, device):
    """The JAX probe's draws, in its order: int8 x and HWIO weight, the
    scale, bf16 x and weight. The int8 weight is returned packed for K1
    (Cout, 9*Cin) and for K3 (9*Cout, Cin)."""
    x8 = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    w8 = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    sc = rng.uniform(0.001, 0.01, (cout,)).astype(np.float32)
    xbf = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wbf = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(
        w8.reshape(9 * cin, cout).T)).to(device)
    return dict(x8=torch.from_numpy(x8).to(device), wt=wt,
                wn=q.pack_ncat_weight(wt),
                scale=torch.from_numpy(sc).to(device),
                xbf=torch.from_numpy(xbf).to(device, torch.bfloat16),
                wbf=torch.from_numpy(wbf).to(device, torch.bfloat16))


def device_launches(fn) -> int:
    """The work that one fn() call puts on the card: the nodes (kernels,
    memsets and copies alike) of a CUDA graph captured around it, counted
    by the CUDA driver's cuGraphGetNodes."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    nodes = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    return nodes.value


def probe_config(cfg, rng, device="cuda", reps=20) -> dict:
    """One configuration: a row for bf16, the library int8 route and each
    kernel. On the CPU only the plain versions run, untimed."""
    from .utils.timing import bound, time_ms

    name, b, h, w, cin, cout = cfg
    d = make_inputs(rng, b, h, w, cin, cout, device)
    x8, wt, wn, sc = d["x8"], d["wt"], d["wn"], d["scale"]
    ones = torch.ones(cout, device=device)
    m = b * h * w
    ops = 2 * m * 9 * cin * cout
    nbytes = m * cin + 9 * cin * cout + 4 * cout + 2 * m * cout
    on_card = torch.device(device).type == "cuda"
    ref = q.conv3x3_s8_plain(x8, wt, ones, torch.float32)
    out = dict(config=name, shape=[b, h, w, cin, cout], rows=[])
    if on_card:
        kind = torch.cuda.get_device_name(0)
        bms, by = bound(ops, nbytes, kind)
        xc = d["xbf"].permute(0, 3, 1, 2)            # channels-last NCHW
        wc = d["wbf"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t_bf = time_ms(lambda: F.conv2d(xc, wc, padding=1), reps)
        out["rows"].append(dict(name="bf16", ms=t_bf, tops=ops / t_bf / 1e9,
                                x_bf16=1.0))
        cols = q.im2col_rows(x8)
        wcol = wt.T
        lib = torch._int_mm(cols, wcol)
        lib_exact = bool(torch.equal(lib.float().reshape(ref.shape), ref))
        del lib
        t_lib = time_ms(lambda: torch._int_mm(cols, wcol), reps)
        del cols
        out["rows"].append(dict(name="int_mm", ms=t_lib,
                                tops=ops / t_lib / 1e9, x_bf16=t_bf / t_lib,
                                exact=lib_exact))
        out["bound_ms"], out["bound_by"] = bms, by
    k1 = None
    for kname, (kernel, plain, launch_name) in KERNELS.items():
        want = plain(x8, wt, wn, ones, torch.float32)
        row = dict(name=kname, kernel=launch_name,
                   plain_exact=bool(torch.equal(want, ref)))
        if on_card:
            before = _lib.launch_counts().get(launch_name, 0)
            got = kernel(x8, wt, wn, ones, torch.float32)
            torch.cuda.synchronize()
            k1 = got if k1 is None else k1
            row.update(exact=bool(torch.equal(got, want)),
                       equals_k1=bool(torch.equal(got, k1)),
                       max_abs_err=(got - want).abs().max().item())
            del got
            t = time_ms(lambda: kernel(x8, wt, wn, sc, torch.bfloat16), reps)
            row.update(ms=t, tops=ops / t / 1e9, x_bf16=t_bf / t,
                       plain_ms=time_ms(lambda: plain(x8, wt, wn, sc,
                                                      torch.bfloat16),
                                        reps=3, warm=1),
                       bound_ms=bms, bound_by=by, library_ms=t_lib,
                       launches=_lib.launch_counts().get(launch_name, 0)
                       - before)
        del want
        out["rows"].append(row)
    return out


def run(configs: Sequence = CONFIGS, device="cuda", reps=20) -> List[dict]:
    """Probe each configuration, printing one JSON line each. On the card,
    each kernel's device launches a call (`launches_per_call`, from a
    captured CUDA graph) are counted once every configuration is timed."""
    rng = np.random.default_rng(0)
    results = [probe_config(cfg, rng, device, reps) for cfg in configs]
    if torch.device(device).type == "cuda":
        for (_, b, h, w, cin, cout), res in zip(configs, results):
            d = make_inputs(np.random.default_rng(0), b, h, w, cin, cout,
                            device)
            for row in res["rows"]:
                if "kernel" in row:
                    kernel = KERNELS[row["name"]][0]
                    row["launches_per_call"] = device_launches(
                        lambda: kernel(d["x8"], d["wt"], d["wn"], d["scale"],
                                       torch.bfloat16))
    for res in results:
        print(json.dumps(res), flush=True)
    return results


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qconv_probe: no CUDA device (run(device='cpu') "
                         "checks the plain versions)")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    with torch.inference_mode():
        results = run()
    bad = [(r["config"], row["name"]) for r in results for row in r["rows"]
           if not all(row.get(k, True) for k in ("exact", "equals_k1",
                                                  "plain_exact"))]
    if bad:
        raise SystemExit(f"qconv_probe: inexact rows {bad}")


if __name__ == "__main__":
    main()
