"""int8 3x3 stride-1 SAME convolution, NHWC, s8 x s8 -> s32.

Counterpart of `reid_tpu/ops/qconv.py:conv3x3_s8`. On a CUDA tensor the
wrapper launches the hand-written implicit-GEMM kernel in `csrc/qconv.cu`
(`wgmma` on the int8 tensor cores fed by TMA, fused dequant epilogue); on
a CPU tensor it computes the plain version, `conv3x3_s8_plain`.

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


def _check(name: str, x: torch.Tensor, wt: torch.Tensor,
           scale: torch.Tensor, out_dtype, cout: int, wt_shape) -> None:
    """The checks of the conv kernels' contract: int8 x (B, H, W, Cin) and
    weight of `wt_shape`, (Cout,) f32 scale, Cin % 64 == 0,
    Cout % 128 == 0, bf16 or f32 out, contiguous 16-byte aligned tensors
    on one device."""
    cin = x.shape[-1]
    if x.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 x and wt, got {x.dtype}, "
                        f"{wt.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (cout,):
        raise TypeError(f"scale must be ({cout},) float32")
    if tuple(wt.shape) != tuple(wt_shape):
        raise ValueError(f"wt {tuple(wt.shape)} is not {tuple(wt_shape)}")
    if cin % 64 or cout % 128:
        raise ValueError(f"{name} needs Cin % 64 == 0 and Cout % 128 == 0,"
                         f" got {cin}, {cout}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    for t in (x, wt, scale):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous, 16-byte aligned "
                             "tensors on one device")


def _out_dtype(out_f32: bool):
    return torch.float32 if out_f32 else torch.bfloat16


# K1 is the custom op `reid_tpu_torch::conv3x3_s8`, so that `torch.export`
# traces it as one node (a serving artifact keeps it) and dispatches it by
# device: the plain version on a CPU tensor, the kernel on a CUDA tensor.
@torch.library.custom_op("reid_tpu_torch::conv3x3_s8", mutates_args=(),
                         device_types="cpu")
def _conv3x3_s8_op(x: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
                   out_f32: bool) -> torch.Tensor:
    return conv3x3_s8_plain(x, wt, scale, _out_dtype(out_f32))


@_conv3x3_s8_op.register_fake
def _(x, wt, scale, out_f32):
    return x.new_empty((*x.shape[:3], wt.shape[0]), dtype=_out_dtype(out_f32))


def conv3x3_s8(x: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """3x3 / stride-1 / SAME conv: int8 NHWC x packed int8 -> `out_dtype`.

    x (B, H, W, Cin) int8; wt (Cout, 9*Cin) int8 from `pack_conv_weight`;
    scale (Cout,) f32 (act_scale * w_scale) multiplied into the s32
    accumulator. Returns (B, H, W, Cout) in bf16 or f32."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    return torch.ops.reid_tpu_torch.conv3x3_s8(x, wt, scale,
                                               out_dtype == torch.float32)


@_conv3x3_s8_op.register_kernel("cuda")
def _(x, wt, scale, out_f32):
    out_dtype = _out_dtype(out_f32)
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    _check(NAME, x, wt, scale, out_dtype, cout, (cout, 9 * cin))
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    fn = _lib.function("qconv", "reid_conv3x3_s8", [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(), out.data_ptr(),
             b, h, w, cin, cout, int(out_dtype == torch.float32),
             _lib.stream_of(x))
    _lib.check(err, NAME)
    _lib.count_launch(NAME, (h, w, cin, cout))
    return out


# ---------------------------------------------------------------------------
# Three more forms of the same convolution (csrc/qconv_variants.cu), each
# with conv3x3_s8's contract and, beside it, a plain version that follows
# its formulation in float64 (exact for every K of the trunk).

NCAT, BITSHIFT, DMA = ("conv3x3_s8_ncat", "conv3x3_s8_bitshift",
                       "conv3x3_s8_dma")
_TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
# memory budget of the plain versions' per-block intermediate (ncat's s32
# product, dma's int8 im2col buffer) when img_block is 0
SCRATCH_BYTES = 256 << 20
# K3's tile on the card: 128 box rows x the nine taps of 16 output channels
NCAT_BM, NCAT_GROUP = 128, 16


def ncat_plan(b: int, h: int, w: int, img_block: int = 0) -> dict:
    """K3's A boxes on the card: whole image rows (bw = W) of one
    128-row tile. Where an image fits, bn whole images a box (at most
    `img_block` where positive) and no halo. Else bh = 128 // W rows, the
    first and the last of them halo rows whose products the box computes
    and drops, so a box advances step_y = bh - 2 output rows. `recomputed`
    is the share of the tiles' rows that are not output pixels. Raises
    ValueError where a box cannot hold an output row and its halo."""
    if h * w <= NCAT_BM:
        bn = max(1, min(NCAT_BM // (h * w), b))
        if img_block > 0:
            bn = min(bn, img_block)
        bh, halo = h, 0
    else:
        bh, bn, halo = NCAT_BM // w, 1, 1
        if bh < 3:
            raise ValueError(f"{NCAT}: W = {w} leaves no output row in a "
                             f"{NCAT_BM}-pixel box with its halo rows")
    step_y = bh - 2 * halo
    tiles_y = -(-h // step_y)
    tiles_m = tiles_y * -(-b // bn)
    return dict(bw=w, bh=bh, bn=bn, halo=halo, step_y=step_y,
                tiles_y=tiles_y, tiles_m=tiles_m,
                recomputed=1.0 - b * h * w / (tiles_m * NCAT_BM)
                if tiles_m else 0.0)


def ncat_group_weight(wn: torch.Tensor) -> torch.Tensor:
    """`pack_ncat_weight`'s (9*Cout, Cin) -> (Cout/G, 9, G, Cin): the order
    in which K3's weight map reads an N tile, all nine taps of G = 16
    output channels (a view; the kernel reads `wn` itself)."""
    cout = wn.shape[0] // 9
    return wn.reshape(9, cout // NCAT_GROUP, NCAT_GROUP, -1).transpose(0, 1)


def dma_plan(b: int, h: int, w: int, cout: int) -> dict:
    """K5's tiles on the card: bm consecutive output pixels in flat NHW
    order (128 where Cout % 256 == 0, with 256 channels; else 256 with
    128), crossing image rows and images."""
    bm = 128 if cout % 256 == 0 else 256
    return dict(bm=bm, tiles_m=-(-b * h * w // bm))


def pack_ncat_weight(wt: torch.Tensor) -> torch.Tensor:
    """`pack_conv_weight`'s (Cout, 9*Cin) -> (9*Cout, Cin), tap-major along
    N: row t*Cout + o holds tap t of output channel o (the JAX kernel's
    (Cin, 9*Cout) weight, transposed)."""
    cout = wt.shape[0]
    return wt.reshape(cout, 9, -1).transpose(0, 1).reshape(
        9 * cout, -1).contiguous()


def unpack_ncat_weight(wn: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_ncat_weight`."""
    cout = wn.shape[0] // 9
    return wn.reshape(9, cout, -1).transpose(0, 1).reshape(
        cout, -1).contiguous()


def img_block_for(b: int, h: int, w: int, row_bytes: int,
                  img_block: int = 0) -> int:
    """Images per block of a plain version: `img_block` if positive, else
    as many as keep a block's intermediate of `row_bytes` a row within
    SCRATCH_BYTES; at most the batch, and few enough that a block's rows
    fit an int32."""
    if img_block <= 0:
        img_block = SCRATCH_BYTES // (h * w * row_bytes)
    return max(1, min(b, img_block, (2 ** 31 - 1) // (h * w * row_bytes)))


def _row_masks(nimg: int, h: int, w: int, device) -> torch.Tensor:
    """(9, nimg*h*w) bool: tap t reaches inside the image of each flat row
    (`reid_tpu/ops/qconv.py:_row_masks`)."""
    r = torch.arange(nimg * h * w, device=device)
    hi, wi = (r // w) % h, r % w
    return torch.stack([(hi + dy >= 0) & (hi + dy < h) & (wi + dx >= 0)
                        & (wi + dx < w) for dy, dx in _TAPS])


def _by_blocks(x: torch.Tensor, cout: int, out_dtype, img_block: int, fn):
    """Run `fn(x_block) -> f32 (rows, cout)` over blocks of `img_block`
    images into a (B, H, W, Cout) tensor of `out_dtype`."""
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    for i0 in range(0, b, img_block):
        xb = x[i0:i0 + img_block]
        out[i0:i0 + img_block] = fn(xb).to(out_dtype).reshape(
            xb.shape[0], h, w, cout)
    return out


def conv3x3_s8_ncat_plain(x: torch.Tensor, wn: torch.Tensor,
                          scale: torch.Tensor, out_dtype=torch.bfloat16,
                          img_block: int = 0) -> torch.Tensor:
    """K3's formulation (`_qconv_ncat_kernel`): per block of images,
    P = x @ wn^T (rows, 9*Cout), then the nine column slices of P rolled by
    the tap's row offset, masked and summed; `* scale`."""
    b, h, w, cin = x.shape
    cout = wn.shape[0] // 9
    img_block = img_block_for(b, h, w, 4 * 9 * cout, img_block)
    wd = wn.to(torch.float64).T

    def block(xb):
        p = xb.reshape(-1, cin).to(torch.float64) @ wd
        masks = _row_masks(xb.shape[0], h, w, x.device)
        acc = torch.zeros((p.shape[0], cout), dtype=torch.float64,
                          device=x.device)
        for t, (dy, dx) in enumerate(_TAPS):
            seg = torch.roll(p[:, t * cout:(t + 1) * cout], -(dy * w + dx), 0)
            acc += torch.where(masks[t][:, None], seg, 0.0)
        return acc.to(torch.float32) * scale.to(torch.float32)
    return _by_blocks(x, cout, out_dtype, img_block, block)


def im2col_rows(xb: torch.Tensor) -> torch.Tensor:
    """(n, H, W, Cin) -> (n*H*W, 9*Cin), columns ordered (tap, cin): the
    nine row windows of the flat rows at the taps' offsets, masked rows
    zero (`_qconv_dma_kernel`'s buffer)."""
    n, h, w, cin = xb.shape
    rows, pad = n * h * w, w + 1
    xp = torch.zeros((rows + 2 * pad, cin), dtype=xb.dtype, device=xb.device)
    xp[pad:pad + rows] = xb.reshape(rows, cin)
    masks = _row_masks(n, h, w, xb.device)
    zero = torch.zeros((), dtype=xb.dtype, device=xb.device)
    return torch.cat([torch.where(masks[t][:, None],
                                  xp[pad + dy * w + dx:pad + dy * w + dx
                                     + rows], zero)
                      for t, (dy, dx) in enumerate(_TAPS)], dim=1)


def conv3x3_s8_dma_plain(x: torch.Tensor, wt: torch.Tensor,
                         scale: torch.Tensor, out_dtype=torch.bfloat16,
                         img_block: int = 0) -> torch.Tensor:
    """K5's formulation: per block of images, the (rows, 9*Cin) im2col,
    then ONE product with the packed weight over K = 9*Cin; `* scale`."""
    b, h, w, cin = x.shape
    img_block = img_block_for(b, h, w, 9 * cin, img_block)
    wd = wt.to(torch.float64).T

    def block(xb):
        acc = im2col_rows(xb).to(torch.float64) @ wd
        return acc.to(torch.float32) * scale.to(torch.float32)
    return _by_blocks(x, wt.shape[0], out_dtype, img_block, block)


def conv3x3_s8_bitshift_plain(x: torch.Tensor, wt: torch.Tensor,
                              scale: torch.Tensor, out_dtype=torch.bfloat16
                              ) -> torch.Tensor:
    """K4's formulation (`_qconv_bitshift_kernel`): the explicit
    (rows, 9*Cin) im2col, then one product over K = 9*Cin, as
    `conv3x3_s8_dma_plain` (blocked only to bound its memory)."""
    return conv3x3_s8_dma_plain(x, wt, scale, out_dtype)


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, *args) -> None:
    fn = _lib.function("qconv_variants", "reid_" + name,
                       [ctypes.c_void_p if isinstance(a, ctypes.c_void_p)
                        else ctypes.c_int for a in args])
    _lib.check(fn(*args), name)
    b, h, w, cin = x.shape
    _lib.count_launch(name, (h, w, cin, out.shape[-1]))


def conv3x3_s8_ncat(x: torch.Tensor, wn: torch.Tensor, scale: torch.Tensor,
                    img_block: int = 0, out_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """`conv3x3_s8`'s contract with the weight from `pack_ncat_weight`
    (9*Cout, Cin): one s8 product against all nine taps' weights, then the
    tap sum. On the card one launch whose tiles keep the product in shared
    memory (`ncat_plan`); `img_block` caps the images of one tile box, as
    it caps the images of a block in the reference (0: as many as fit).
    Raises ValueError where W is too wide for a box (`ncat_plan`)."""
    if x.device.type == "cpu":
        return conv3x3_s8_ncat_plain(x, wn, scale, out_dtype, img_block)
    b, h, w, cin = x.shape
    cout = wn.shape[0] // 9
    _check(NCAT, x, wn, scale, out_dtype, cout, (9 * cout, cin))
    plan = ncat_plan(b, h, w, img_block)
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    _launch(NCAT, x, out, _lib.ptr(x), _lib.ptr(wn), _lib.ptr(scale),
            _lib.ptr(out), b, h, w, cin, cout, plan["bh"], plan["bn"],
            plan["halo"], int(out_dtype == torch.float32), _lib.stream_of(x))
    return out


def conv3x3_s8_dma(x: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
                   img_block: int = 0, out_dtype=torch.bfloat16
                   ) -> torch.Tensor:
    """`conv3x3_s8`'s contract: the masked im2col of each tap, then one s8
    product over K = 9*Cin. On the card one launch: TMA's im2col mode
    copies each tap's rows of a tile of flat output pixels into shared
    memory (`dma_plan`), no buffer in device memory. `img_block` bounds
    only the plain version's blocking: the card's tiles cross images."""
    if x.device.type == "cpu":
        return conv3x3_s8_dma_plain(x, wt, scale, out_dtype, img_block)
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    _check(DMA, x, wt, scale, out_dtype, cout, (cout, 9 * cin))
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    _launch(DMA, x, out, _lib.ptr(x), _lib.ptr(wt), _lib.ptr(scale),
            _lib.ptr(out), b, h, w, cin, cout, dma_plan(b, h, w, cout)["bm"],
            int(out_dtype == torch.float32), _lib.stream_of(x))
    return out


# dynamic shared memory a block may take (H100), and K4's epilogue staging
# (wg::ScaleEpi's in f32, taken for both outputs): 8 warps x 16 rows x
# (64 f32 + 32 bytes of padding)
SMEM_MAX = 232448
_EPI_BYTES = 8 * 16 * (64 * 4 + 32)


def bitshift_plan(b: int, h: int, w: int, cin: int, cout: int) -> dict:
    """K4's tiles and shared memory on the card: K1's tiles of bm flat
    output pixels x bn channels (128 x 256 where Cout % 256 == 0, else
    256 x 128) and K chunks of bk channels (128 where Cin allows, else
    64). A slab holds a tile's rows and W + 1 rows on each side,
    `slab_rows`, loaded as `boxes` TMA boxes of `box_rows` (a multiple of
    8, at most 256); two slabs, then as many B stages of (bn x bk) as fit
    (at most 6). Raises ValueError where a row is too wide for two boxes
    or for three B stages beside the slabs."""
    bk = 128 if cin % 128 == 0 else 64
    bm, bn = (128, 256) if cout % 256 == 0 else (256, 128)
    slab_rows = bm + 2 * (w + 1)
    boxes = 1 if slab_rows <= 256 else 2
    per_box = -(-slab_rows // boxes)
    box_rows = -(-per_box // 8) * 8
    if box_rows > 256:
        raise ValueError(f"{BITSHIFT}: W = {w} makes a slab of {slab_rows} "
                         "rows, more than two TMA boxes of 256")
    slab_bytes = -(-boxes * box_rows * bk // 1024) * 1024
    # the ring's stages, each with its two barriers, beside two slabs, the
    # staging, the four slab barriers and the 1024 bytes of alignment
    free = SMEM_MAX - 1024 - _EPI_BYTES - 2 * slab_bytes - 4 * 8
    stages = min(6, free // (bn * bk + 16))
    if stages < 3:
        raise ValueError(f"{BITSHIFT}: W = {w} leaves room for {stages} B "
                         "stages beside the slabs, fewer than 3")
    return dict(bm=bm, bn=bn, bk=bk, slab_rows=slab_rows, boxes=boxes,
                box_rows=box_rows, stages=stages,
                tiles_m=-(-b * h * w // bm))


def conv3x3_s8_bitshift(x: torch.Tensor, wt: torch.Tensor,
                        scale: torch.Tensor, out_dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """`conv3x3_s8`'s contract: per tile of flat output pixels and chunk
    of input channels, the tile's rows and their halo are loaded into
    shared memory once, and all nine taps read their operands from that
    slab at the tap's row offset, masked in registers (`bitshift_plan`).
    Raises ValueError where W is too wide for the slab."""
    if x.device.type == "cpu":
        return conv3x3_s8_bitshift_plain(x, wt, scale, out_dtype)
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    _check(BITSHIFT, x, wt, scale, out_dtype, cout, (cout, 9 * cin))
    plan = bitshift_plan(b, h, w, cin, cout)
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    _launch(BITSHIFT, x, out, _lib.ptr(x), _lib.ptr(wt), _lib.ptr(scale),
            _lib.ptr(out), b, h, w, cin, cout, plan["bm"], plan["box_rows"],
            plan["boxes"], plan["stages"], int(out_dtype == torch.float32),
            _lib.stream_of(x))
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
