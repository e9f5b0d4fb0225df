"""int8 3x3 stride-1 SAME convolution, NHWC, s8 x s8 -> s32.

Counterpart of `reid_tpu/ops/qconv.py:conv3x3_s8`. On a CUDA tensor the
wrapper launches the hand-written implicit-GEMM kernel in
`csrc/qconv.cu` (int8 tensor cores, fused dequant epilogue); on a CPU
tensor it computes the plain version, `conv3x3_s8_plain`.

The weight is taken pre-laid out as (Cout, 9*Cin) with K ordered
(tap, cin) (`pack_conv_weight`), done once at quantization time.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _lib

NAME = "conv3x3_s8"


def pack_conv_weight(w_oihw: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) -> (Cout, kh*kw*Cin), K ordered (dy, dx, cin):
    the order of an NHWC im2col row and of the kernel's K loop."""
    cout = w_oihw.shape[0]
    return w_oihw.permute(0, 2, 3, 1).reshape(cout, -1).contiguous()


def unpack_conv_weight(wt: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Inverse of `pack_conv_weight`: (Cout, kh*kw*Cin) -> OIHW."""
    cout = wt.shape[0]
    return wt.reshape(cout, kh, kw, -1).permute(0, 3, 1, 2)


def quantize_s8(v: torch.Tensor, inv_s: float) -> torch.Tensor:
    """clip(round(v * inv_s), +-127) as int8, rounding half to even."""
    return torch.clamp(torch.round(v.to(torch.float32) * inv_s),
                       -127.0, 127.0).to(torch.int8)


def conv_acc_plain(xq: torch.Tensor, wt: torch.Tensor, k: int,
                   stride: int = 1, padding: int | None = None
                   ) -> torch.Tensor:
    """Exact s32 accumulator of a k x k conv of int8 NHWC `xq` with the
    packed weight `wt`, computed in float64 (exact while |acc| < 2^53, so
    for every K of the trunk) and returned as f32, the rounding of
    `acc.astype(f32)`. SAME padding unless `padding` is given."""
    w = unpack_conv_weight(wt, k, k).to(torch.float64)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64), w,
                   stride=stride,
                   padding=k // 2 if padding is None else padding)
    return acc.permute(0, 2, 3, 1).to(torch.float32)


def conv3x3_s8_plain(x: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Same contract in exact arithmetic; counterpart of
    `conv3x3_s8_reference`."""
    return (conv_acc_plain(x, wt, 3) * scale.to(torch.float32)).to(out_dtype)


def conv3x3_s8(x: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """3x3 / stride-1 / SAME conv: int8 NHWC x packed int8 -> `out_dtype`.

    x (B, H, W, Cin) int8; wt (Cout, 9*Cin) int8 from `pack_conv_weight`;
    scale (Cout,) f32 (act_scale * w_scale) multiplied into the s32
    accumulator. Returns (B, H, W, Cout) in bf16 or f32."""
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, wt, scale, out_dtype)
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    if x.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"conv3x3_s8 takes int8 x and wt, got {x.dtype}, "
                        f"{wt.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (cout,):
        raise TypeError(f"scale must be ({cout},) float32")
    if tuple(wt.shape) != (cout, 9 * cin):
        raise ValueError(f"wt {tuple(wt.shape)} is not (Cout, 9*{cin})")
    if cin % 64 or cout % 128:
        raise ValueError(f"conv3x3_s8 needs Cin % 64 == 0 and Cout % 128 == 0,"
                         f" got {cin}, {cout}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    for t in (x, wt, scale):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("conv3x3_s8 takes contiguous, 16-byte aligned "
                             "tensors on one device")
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    lib = _lib.load("qconv")
    fn = lib.reid_conv3x3_s8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    err = fn(_lib.ptr(x), _lib.ptr(wt), _lib.ptr(scale), _lib.ptr(out),
             b, h, w, cin, cout, int(out_dtype == torch.float32),
             _lib.stream_of(x))
    _lib.check(err, NAME)
    _lib.count_launch(NAME, (h, w, cin, cout))
    return out


def qconv_applicable(x_shape: Tuple[int, ...], kq_shape: Tuple[int, ...],
                     stride, padding, groups: int = 1,
                     dilation=(1, 1)) -> bool:
    """True when `conv3x3_s8` covers this conv: 3x3, stride 1, SAME
    (padding 1), no dilation or groups, Cin and Cout multiples of 128.
    `kq_shape` is OIHW (Cout, Cin, 3, 3)."""
    if len(x_shape) != 4 or tuple(kq_shape[2:]) != (3, 3):
        return False
    if groups != 1 or tuple(stride) != (1, 1) or tuple(dilation) != (1, 1):
        return False
    if tuple(padding) != (1, 1):
        return False
    cout, cin = kq_shape[0], kq_shape[1]
    return cin % 128 == 0 and cout % 128 == 0
