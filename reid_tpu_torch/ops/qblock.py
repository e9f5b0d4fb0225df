"""Fused int8 SE basic block (stride 1), bf16 in and bf16 out.

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
`csrc/qblock.cu`; on a CPU tensor it computes `se_basic_block_s8_plain`.
Conv weights are packed (Cout, taps*Cin), K ordered (tap, cin).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _lib
from .qconv import conv_acc_plain, quantize_s8

NAME = "se_basic_block_s8"
_STRIPES = 8    # kRedStripes of csrc/qblock.cu: rows each thread strides


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


def _image_mean(v: torch.Tensor, kernel_order: bool) -> torch.Tensor:
    """(b, h, w, c) f32 -> (b, 1, 1, c) per-image channel means: the sum
    over H*W rows divided by H*W. In the kernel's fixed order
    (`chan_mean_kernel`), stripe s adds rows s, s + 8, s + 16, ... in turn
    and the 8 stripe sums are then added in order; otherwise torch sums."""
    b, h, w, c = v.shape
    if not kernel_order:
        return v.sum(dim=(1, 2), keepdim=True) / (h * w)
    rows = v.reshape(b, h * w, c)
    acc = rows.new_zeros((b, _STRIPES, c))
    for r0 in range(0, h * w, _STRIPES):
        part = rows[:, r0:r0 + _STRIPES]
        acc[:, :part.shape[1]] += part
    total = acc[:, 0]
    for s in range(1, _STRIPES):
        total = total + acc[:, s]
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


def _scratch(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def se_basic_block_s8(x: torch.Tensor, p: QBlockParams, ibn: bool = False,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused int8 SE basic block (stride 1): bf16 (B,H,W,Cin) ->
    (B,H,W,Cout). `p.wd is not None` selects the 1x1 int8 down branch,
    otherwise Cin == Cout and the identity branch is used. `ibn=True`
    applies IBN-a after conv1."""
    if x.device.type == "cpu":
        return se_basic_block_s8_plain(x, p, ibn, out_dtype)
    b, h, w, cin = x.shape
    cout = p.w2.shape[0]
    mip = p.wfc1.shape[1]
    down = p.wd is not None
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError("se_basic_block_s8 takes and returns bfloat16")
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
    m = b * h * w
    i8, f32 = torch.int8, torch.float32
    xq = _scratch((m, cin), i8, x)
    xqd = _scratch((m, cin), i8, x) if down else None
    y1 = _scratch((m, cout), f32, x) if ibn else None
    hq = _scratch((m, cout), i8, x)
    y2 = _scratch((m, cout), f32, x)
    stats = _scratch((2, b, cout), f32, x) if ibn else None
    pooled = _scratch((b, cout), f32, x)
    gate = _scratch((b, cout), f32, x)
    branch = _scratch((m, cout), f32, x) if down else None
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=x.device)

    def opt(t):
        return _lib.ptr(t) if t is not None else None

    lib = _lib.load("qblock")
    fn = lib.reid_se_basic_block_s8
    fn.restype = ctypes.c_int
    vp, fl, ci = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn.argtypes = ([vp] * 7 + [fl, fl] + [vp] * 5 + [fl] + [vp] * 13
                   + [ci] * 7 + [vp])
    err = fn(_lib.ptr(x), _lib.ptr(p.w1), _lib.ptr(p.w2), _lib.ptr(p.a1),
             _lib.ptr(p.c1), _lib.ptr(p.a2), _lib.ptr(p.c2),
             p.inv_sx1, p.inv_sx2, _lib.ptr(p.wfc1), _lib.ptr(p.wfc2),
             opt(p.wd), opt(p.ad), opt(p.cd),
             p.inv_sxd if down else 0.0,
             opt(p.dq1_vec) if ibn else None,
             opt(p.in_scale) if ibn else None,
             opt(p.in_bias) if ibn else None,
             _lib.ptr(xq), opt(xqd), opt(y1), _lib.ptr(hq), _lib.ptr(y2),
             opt(stats), _lib.ptr(pooled), _lib.ptr(gate), opt(branch),
             _lib.ptr(out), b, h, w, cin, cout, mip, int(ibn),
             _lib.stream_of(x))
    _lib.check(err, NAME)
    _lib.count_launch(NAME, (h, w, cin, cout, int(ibn)))
    return out
