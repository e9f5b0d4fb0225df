"""Fused int8 SE basic block (stride 1): bf16 in and out (the bf16 trunk of
the track path) or f32 in and out (the f32 trunk of retrieval).

Counterpart of `reid_tpu/ops/qblock.py:se_basic_block_s8`. Per block:

    xq   = clip(round(x * inv_sx1))                   # quantize
    a1   = conv3x3(xq, W1q)                           # s8 x s8 -> s32
    h    = relu(a1 * A1 + C1)                         # BN1 folded affine
    hq   = clip(round(h * inv_sx2))                   #   (or IBN-a)
    a2   = conv3x3(hq, W2q)
    y    = a2 * A2 + C2                               # BN2 folded affine
    g    = sigmoid(fc2(relu(fc1(mean_img(y)))))       # SE gate, bf16 fcs
    r    = x  or  clip(round(x * inv_sxd)) @ Wdq * Ad + Cd
    out  = relu(y * g + r)

On a CUDA tensor the wrapper runs the hand-written launch sequence of
`csrc/qblock.cu` (its three GEMMs on the `wgmma` mainloop shared with
`conv3x3_s8`, fused epilogues); on a CPU tensor it computes
`se_basic_block_s8_plain`. Conv weights are packed (Cout, taps*Cin), K
ordered (tap, cin).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _lib
from .qconv import conv_acc_plain, quantize_s8

NAME = "se_basic_block_s8"
_STRIPES = 8    # kStripes of csrc/qblock.cu: the stripes of a per-image sum


class QBlockParams(NamedTuple):
    """Folded parameters of one fused block (device tensors and f32-valued
    Python floats). The contract of `reid_tpu.ops.qblock.QBlockParams`,
    with conv weights packed as (Cout, taps*Cin)."""
    w1: torch.Tensor          # (cout, 9*cin) int8
    w2: torch.Tensor          # (cout, 9*cout) int8
    a1: torch.Tensor          # (cout,) f32
    c1: torch.Tensor          # (cout,) f32
    a2: torch.Tensor          # (cout,) f32 folded
    c2: torch.Tensor          # (cout,) f32
    inv_sx1: float            # 1/act_scale of conv1 (an f32 value)
    inv_sx2: float            # 1/act_scale of conv2
    wfc1: torch.Tensor        # (cout, mip) bf16 - SE squeeze
    wfc2: torch.Tensor        # (mip, cout) bf16 - SE excite
    wd: Optional[torch.Tensor] = None        # (cout, cin) int8 1x1 down conv
    ad: Optional[torch.Tensor] = None        # (cout,) f32 folded
    cd: Optional[torch.Tensor] = None        # (cout,) f32
    inv_sxd: Optional[float] = None
    dq1_vec: Optional[torch.Tensor] = None   # (cout,) f32 sx1*sw1 (ibn only)
    in_scale: Optional[torch.Tensor] = None  # (cout,) f32 (ibn only)
    in_bias: Optional[torch.Tensor] = None   # (cout,) f32 (ibn only)


def fold_bn(scale, bias, mean, var, eps=1e-5):
    """Inference BatchNorm -> per-channel affine (a, c): y = a*x + c."""
    f32 = torch.float32
    a = scale.to(f32) / torch.sqrt(var.to(f32) + eps)
    c = bias.to(f32) - mean.to(f32) * a
    return a, c


def tile_segments(h: int, w: int, cout: int):
    """The pixel ranges [p0, p1) of one image, in row-major pixel order,
    that the kernel's output tiles hold: tiles of 128 rows where
    Cout % 256 == 0, else of 256, each a box of bw = min(W, rows) pixels by
    bh = min(H, rows // bw) image rows, so its part of an image is one
    contiguous range. One range where a tile holds whole images."""
    rows = 128 if cout % 256 == 0 else 256
    bw = min(w, rows)
    bh = min(h, rows // bw)
    return [(y0 * w + x0, y0 * w + x0 + min(bh, h - y0) * min(bw, w - x0))
            for y0 in range(0, h, bh) for x0 in range(0, w, bw)]


def _image_mean(v: torch.Tensor, kernel_order: bool) -> torch.Tensor:
    """(b, h, w, c) f32 -> (b, 1, 1, c) per-image channel means: the sum
    over H*W rows divided by H*W. In the kernel's fixed order, each tile's
    part of an image (`tile_segments`) is summed in 8 stripes, stripe s
    adding the part's rows s, s + 8, s + 16, ... in turn, then the stripes
    in order; the parts' sums are added in tile order (one part where a
    tile holds whole images). Otherwise torch sums."""
    b, h, w, c = v.shape
    if not kernel_order:
        return v.sum(dim=(1, 2), keepdim=True) / (h * w)
    rows = v.reshape(b, h * w, c)
    total = None
    for p0, p1 in tile_segments(h, w, c):
        acc = rows.new_zeros((b, _STRIPES, c))
        for r0 in range(p0, p1, _STRIPES):
            part = rows[:, r0:min(r0 + _STRIPES, p1)]
            acc[:, :part.shape[1]] += part
        seg = acc[:, 0]
        for s in range(1, _STRIPES):
            seg = seg + acc[:, s]
        total = seg if total is None else total + seg
    return (total / (h * w))[:, None, None, :]


def _fc_warp(v: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(b, c) @ (c, m) in f32, summed as `se_gate_kernel`'s fc1 sums: lane
    l of a warp adds the products of rows l, l + 32, ... in turn, then the
    32 lane sums meet in a butterfly (xor 16, 8, 4, 2, 1)."""
    b, c = v.shape
    pad = -c % 32                   # lanes past c hold no product
    v, wt = F.pad(v, (0, pad)), F.pad(wt, (0, 0, 0, pad))
    prod = (v[:, :, None] * wt[None]).reshape(b, (c + pad) // 32, 32, -1)
    lanes = prod[:, 0]
    for k in range(1, c // 32):
        lanes = lanes + prod[:, k]
    ar = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, ar ^ off]
    return lanes[:, 0]


def _fc_serial(v: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(b, m) @ (m, c) in f32 as `se_gate_kernel`'s fc2: each output adds
    the m products in order."""
    out = torch.zeros((v.shape[0], wt.shape[1]), device=v.device)
    for j in range(v.shape[1]):
        out = out + v[:, j:j + 1] * wt[j][None]
    return out


def se_basic_block_s8_plain(x: torch.Tensor, p: QBlockParams,
                            ibn: bool = False, out_dtype=torch.bfloat16,
                            kernel_order: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the block; follows `qblock_reference`
    (reid_tpu/ops/qblock.py:331-424) op for op: f32 epilogues and exact
    integer convolutions. Like the reference, which sums as its TPU kernel
    does, it sums every per-image reduction and the SE dot products in its
    own kernel's fixed order, so that no requantization tie moves between
    kernel and plain version. `kernel_order=False` sums them as torch does
    instead, which measures how far the kernel's order moves the output."""
    cout = p.w2.shape[0]
    fc1 = _fc_warp if kernel_order else torch.matmul
    fc2 = _fc_serial if kernel_order else torch.matmul
    acc1 = conv_acc_plain(quantize_s8(x, p.inv_sx1), p.w1, 3)
    if ibn:
        y1 = acc1 * p.dq1_vec
        mean = _image_mean(y1, kernel_order)
        sq = _image_mean(y1 * y1, kernel_order)
        var = torch.clamp(sq - mean * mean, min=0.0)
        rstd = 1.0 / torch.sqrt(var + 1e-5)
        y_in = (y1 - mean) * rstd * p.in_scale + p.in_bias
        y_bn = y1 * p.a1 + p.c1
        ch = torch.arange(cout, device=x.device)
        h1 = torch.relu(torch.where(ch < cout // 2, y_in, y_bn))
    else:
        h1 = torch.relu(acc1 * p.a1 + p.c1)
    acc2 = conv_acc_plain(quantize_s8(h1, p.inv_sx2), p.w2, 3)
    y2 = acc2 * p.a2 + p.c2
    pooled = _image_mean(y2, kernel_order)[:, 0, 0, :]
    s = fc1(pooled.to(torch.bfloat16).float(), p.wfc1.float())
    s = torch.relu(s.to(torch.bfloat16)).float()
    gate = torch.reciprocal(1.0 + torch.exp(-fc2(s, p.wfc2.float())))
    if p.wd is not None:
        accd = conv_acc_plain(quantize_s8(x, p.inv_sxd), p.wd, 1)
        branch = accd * p.ad + p.cd
    else:
        branch = x.to(torch.float32)
    out = torch.relu(y2 * gate[:, None, None, :] + branch)
    return out.to(out_dtype)


_WORKSPACE = {}


def _workspace_bytes(key) -> int:
    """Bytes of the kernel's scratch for one call's shape, from the library
    (it lays the scratch out), once per shape."""
    nbytes = _WORKSPACE.get(key)
    if nbytes is None:
        fn = _lib.function("qblock", "reid_se_basic_block_s8_workspace",
                           [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong)])
        out = ctypes.c_longlong(0)
        _lib.check(fn(*key, ctypes.byref(out)), NAME)
        nbytes = _WORKSPACE[key] = out.value
    return nbytes


def _params(w1, w2, a1, c1, a2, c2, inv_sx1, inv_sx2, wfc1, wfc2, wd, ad, cd,
            inv_sxd, dq1_vec, in_scale, in_bias) -> QBlockParams:
    return QBlockParams(w1, w2, a1, c1, a2, c2, inv_sx1, inv_sx2, wfc1, wfc2,
                        wd, ad, cd, inv_sxd if wd is not None else None,
                        dq1_vec, in_scale, in_bias)


def _out_dtype(out_f32: bool):
    return torch.float32 if out_f32 else torch.bfloat16


# K2 is the custom op `reid_tpu_torch::se_basic_block_s8`, with
# `QBlockParams` flattened into its arguments, so that `torch.export`
# traces it as one node and dispatches it by device: the plain version on a
# CPU tensor, the kernel (its workspace allocated inside) on a CUDA tensor.
@torch.library.custom_op("reid_tpu_torch::se_basic_block_s8",
                         mutates_args=(), device_types="cpu")
def _se_basic_block_s8_op(
        x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        a1: torch.Tensor, c1: torch.Tensor, a2: torch.Tensor,
        c2: torch.Tensor, inv_sx1: float, inv_sx2: float,
        wfc1: torch.Tensor, wfc2: torch.Tensor, wd: Optional[torch.Tensor],
        ad: Optional[torch.Tensor], cd: Optional[torch.Tensor],
        inv_sxd: float, dq1_vec: Optional[torch.Tensor],
        in_scale: Optional[torch.Tensor], in_bias: Optional[torch.Tensor],
        ibn: bool, out_f32: bool) -> torch.Tensor:
    p = _params(w1, w2, a1, c1, a2, c2, inv_sx1, inv_sx2, wfc1, wfc2, wd, ad,
                cd, inv_sxd, dq1_vec, in_scale, in_bias)
    return se_basic_block_s8_plain(x, p, ibn, _out_dtype(out_f32))


@_se_basic_block_s8_op.register_fake
def _(x, w1, w2, *rest):
    out_f32 = rest[-1]
    return x.new_empty((*x.shape[:3], w2.shape[0]), dtype=_out_dtype(out_f32))


def se_basic_block_s8(x: torch.Tensor, p: QBlockParams, ibn: bool = False,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused int8 SE basic block (stride 1): (B,H,W,Cin) -> (B,H,W,Cout),
    bf16 to bf16 or f32 to f32. `p.wd is not None` selects the 1x1 int8
    down branch, otherwise Cin == Cout and the identity branch is used.
    `ibn=True` applies IBN-a after conv1."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    return torch.ops.reid_tpu_torch.se_basic_block_s8(
        x, p.w1, p.w2, p.a1, p.c1, p.a2, p.c2, p.inv_sx1, p.inv_sx2, p.wfc1,
        p.wfc2, p.wd, p.ad, p.cd, p.inv_sxd if p.wd is not None else 0.0,
        p.dq1_vec, p.in_scale, p.in_bias, ibn, out_dtype == torch.float32)


@_se_basic_block_s8_op.register_kernel("cuda")
def _(x, w1, w2, a1, c1, a2, c2, inv_sx1, inv_sx2, wfc1, wfc2, wd, ad, cd,
      inv_sxd, dq1_vec, in_scale, in_bias, ibn, out_f32):
    p = _params(w1, w2, a1, c1, a2, c2, inv_sx1, inv_sx2, wfc1, wfc2, wd, ad,
                cd, inv_sxd, dq1_vec, in_scale, in_bias)
    out_dtype = _out_dtype(out_f32)
    b, h, w, cin = x.shape
    cout = p.w2.shape[0]
    mip = p.wfc1.shape[1]
    down = p.wd is not None
    if x.dtype not in (torch.bfloat16, torch.float32) or out_dtype != x.dtype:
        raise TypeError("se_basic_block_s8 takes and returns bfloat16, or "
                        f"float32; got {x.dtype} -> {out_dtype}")
    if not down and cin != cout:
        raise ValueError(f"identity branch needs Cin == Cout, got {cin}, "
                         f"{cout}")
    if cin % 64 or cout % 128:
        raise ValueError(f"se_basic_block_s8 needs Cin % 64 == 0 and "
                         f"Cout % 128 == 0, got {cin}, {cout}")
    if tuple(p.w1.shape) != (cout, 9 * cin) or \
            tuple(p.w2.shape) != (cout, 9 * cout):
        raise ValueError("packed conv weights have the wrong shape")
    if ibn and p.dq1_vec is None:
        raise ValueError("ibn block without dq1_vec / in_scale / in_bias")
    tensors = [x, p.w1, p.w2, p.a1, p.c1, p.a2, p.c2, p.wfc1, p.wfc2]
    if down:
        tensors += [p.wd, p.ad, p.cd]
    if ibn:
        tensors += [p.dq1_vec, p.in_scale, p.in_bias]
    for t in tensors:
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("se_basic_block_s8 takes contiguous, 16-byte "
                             "aligned tensors on one device")
    work = torch.empty(_workspace_bytes((b, h, w, cin, cout, int(ibn),
                                         int(down))),
                       dtype=torch.uint8, device=x.device)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)

    def opt(t):
        return t.data_ptr() if t is not None else None

    vp, fl, ci = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn = _lib.function("qblock", "reid_se_basic_block_s8",
                       [vp] * 7 + [fl, fl] + [vp] * 5 + [fl] + [vp] * 5
                       + [ci] * 8 + [vp])
    err = fn(x.data_ptr(), p.w1.data_ptr(), p.w2.data_ptr(), p.a1.data_ptr(),
             p.c1.data_ptr(), p.a2.data_ptr(), p.c2.data_ptr(),
             p.inv_sx1, p.inv_sx2, p.wfc1.data_ptr(), p.wfc2.data_ptr(),
             opt(p.wd), opt(p.ad), opt(p.cd),
             p.inv_sxd if down else 0.0,
             opt(p.dq1_vec) if ibn else None,
             opt(p.in_scale) if ibn else None,
             opt(p.in_bias) if ibn else None,
             work.data_ptr(), out.data_ptr(), b, h, w, cin, cout, mip,
             int(ibn), int(x.dtype == torch.float32), _lib.stream_of(x))
    _lib.check(err, NAME)
    _lib.count_launch(NAME, (h, w, cin, cout, int(ibn)))
    return out
