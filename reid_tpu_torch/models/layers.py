"""Model primitives of the port's backbones in PyTorch, NHWC like the JAX
package.

Counterparts of `reid_tpu/models/layers.py`: `InstanceNorm`, `IBN`,
`LBN1D`, `SEBlock`, `GeM`, `GeM1D`, `GeM3D`, `AttentionPooling`,
`MetaAconC1D`, BatchNorm or `BatchRenorm` through `make_norm2d` (train
and eval mode), `BatchRenormNonIID`, `conv3x3` / `conv1x1` and
`max_pool_same`; flax's `nn.LayerNorm` and `nn.GroupNorm`; for the
detectors flax's `nn.silu`, `nn.ConvTranspose(padding="SAME")` and the 2x
nearest `jax.image.resize`; for the transformers flax's `nn.gelu` (the
tanh approximation), `nn.Dropout` with its masks drawn from a caller's
`torch.Generator`, and the "SAME" padding of a strided conv; for the
video model a 3-D conv (`Conv3d`) and its (1, 3, 3) max pool
(`max_pool3d`). Activations are (N, H, W, C) at every public function,
(N, T, H, W, C) for a clip, as in the flax modules; a conv permutes to
PyTorch's NCHW view of the same memory (channels-last), so no copy is
made. Each module computes at its `dtype` and keeps its parameters
in f32, casting at the points flax does: convs and dense layers cast their
input and kernel to `dtype`, norms and pooling compute in f32 and return
`dtype`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's variance_scaling(..., "normal") draws a normal truncated at two
# standard deviations, rescaled by this factor to keep the variance
_TRUNC_STD = 0.87962566103423978


def kaiming_(w: torch.Tensor, fan_out: int, generator: torch.Generator):
    """flax kaiming_init: variance_scaling(2.0, "fan_out", "normal")."""
    std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def lecun_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init, lecun_normal: variance_scaling(1.0,
    "fan_in", "truncated_normal")."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def _tf32_convs(allow: bool = True):
    """cuDNN's TF32 allowed (or, with `allow` False, not) inside, its other
    flags as they are."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=allow)


class Conv2d(nn.Conv2d):
    """Conv on NHWC activations (flax `nn.Conv` semantics), bias-free
    unless `bias`; a bias is added in `dtype`, as flax adds it. `groups`
    is flax's `feature_group_count`: a depthwise conv (groups = Cin =
    Cout) has flax's kernel (kh, kw, 1, C), here (C, 1, kh, kw);
    `dilation` is flax's `kernel_dilation`.

    `keep_f32`: the result is read in f32 (a BatchNorm follows, or the
    caller casts it to f32), and the compiled JAX program then skips the
    last rounding to `dtype` (XLA keeps the excess precision): the conv of
    the `dtype`-rounded input and kernel is returned in f32 without a
    bias, and with one the product is rounded to `dtype` and the bias
    added in f32.

    `f32_sum`: on the CPU a `dtype` product is the f32 conv of the
    rounded operands, rounded once, which sums in XLA's CPU order
    (oneDNN's bf16 conv sums in another and moves a few outputs in 10^4
    by an ulp); on the card the conv runs in `dtype` as it is."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, bias: bool = False,
                 keep_f32: bool = False, groups: int = 1,
                 f32_sum: bool = False, dilation: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups, dilation=dilation)
        self.dtype = dtype
        self.keep_f32 = keep_f32
        self.f32_sum = f32_sum

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         init: str = "kaiming"):
        k = self.kernel_size[0] * self.kernel_size[1]
        if init == "kaiming":
            kaiming_(self.weight.data, k * self.out_channels, generator)
        else:
            lecun_(self.weight.data, k * self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias.data)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        kw = dict(stride=self.stride, padding=self.padding,
                  dilation=self.dilation, groups=self.groups)
        w = self.weight.to(self.dtype)
        if self.keep_f32 and self.dtype != torch.float32:
            # TF32 holds a bf16 value exactly and multiplies two exactly,
            # so on the card the f32 conv of these operands may take the
            # TF32 tensor cores without changing what it computes
            xf, wf = x.to(torch.float32), w.to(torch.float32)
            # an exported graph records no `with` block, so under export
            # the flag is the op's; eager keeps the block, as training
            # differentiates through these convs (OSNet, EMA attention,
            # the detector) and the op has no autograd formula
            if torch.compiler.is_exporting():
                from ..ops.conv_tf32 import conv2d_tf32
                y = conv2d_tf32(xf, wf, list(self.stride),
                                list(self.padding), list(self.dilation),
                                self.groups, True)
            else:
                with _tf32_convs():
                    y = F.conv2d(xf, wf, **kw)
        elif self.f32_sum and x.device.type == "cpu":
            y = F.conv2d(x.to(torch.float32), w.to(torch.float32),
                         **kw).to(self.dtype)
        else:
            y = F.conv2d(x, w, **kw)
        y = y.permute(0, 2, 3, 1)
        if self.bias is None:
            return y
        if self.keep_f32:
            return y.to(self.dtype).to(torch.float32) + self.bias.to(
                self.dtype).to(torch.float32)
        return y + self.bias.to(self.dtype)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class Conv3d(nn.Conv3d):
    """Conv on (N, T, H, W, C) clips, bias-free: flax `nn.Conv` with a
    (kT, kH, kW) kernel and the explicit padding k // 2 on each axis
    (`reid_tpu/models/video3d.py:conv3d`). The activations permute to
    PyTorch's NCDHW view of the same memory (channels-last-3d), so no
    copy is made. `dtype`, `keep_f32` and `f32_sum` as `Conv2d`'s. An f32
    conv (`dtype` f32) runs with cuDNN's TF32 off, which cuDNN otherwise
    allows by default and which rounds f32 operands to 10 mantissa
    bits."""

    def __init__(self, cin: int, cout: int, kernel, stride=1,
                 dtype=torch.float32, keep_f32: bool = False,
                 f32_sum: bool = False):
        k = _triple(kernel)
        super().__init__(cin, cout, k, stride=_triple(stride),
                         padding=tuple(x // 2 for x in k), bias=False)
        self.dtype = dtype
        self.keep_f32 = keep_f32
        self.f32_sum = f32_sum

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kt, kh, kw = self.kernel_size
        kaiming_(self.weight.data, kt * kh * kw * self.out_channels,
                 generator)

    def _conv(self, x, w):
        return F.conv3d(x, w, stride=self.stride, padding=self.padding)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3).to(self.dtype)
        w = self.weight.to(self.dtype)
        f32 = torch.float32
        if self.dtype == f32:
            with _tf32_convs(False):
                y = self._conv(x, w)
        elif self.keep_f32:
            # exact for bf16 operands under TF32, as in `Conv2d`
            with _tf32_convs():
                y = self._conv(x.to(f32), w.to(f32))
        elif self.f32_sum and x.device.type == "cpu":
            y = self._conv(x.to(f32), w.to(f32)).to(self.dtype)
        else:
            y = self._conv(x, w)
        return y.permute(0, 2, 3, 4, 1)


def conv_transpose_same_pads(k: int, s: int) -> Tuple[int, int]:
    """The (before, after) padding that `jax.lax.conv_transpose` gives
    the stride-dilated input for padding="SAME": k + s - 2 in all, the
    larger half before (`lax._conv_transpose_padding`)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def conv_transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """lax's (before, after) padding of the dilated input for "SAME" or
    "VALID" (k + s - 2 + max(k - s, 0) in all, k - 1 before)."""
    if padding == "SAME":
        return conv_transpose_same_pads(k, s)
    if padding != "VALID":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    return k - 1, s - 1 + max(k - s, 0)


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class ConvTranspose2d(nn.Module):
    """flax `nn.ConvTranspose(ch, (kh, kw), strides=(sh, sw), padding=
    "SAME" | "VALID")`, with its bias unless `bias` is False, on NHWC
    activations; `k` and `s` are an int or a pair.

    flax correlates the stride-dilated input, padded by lax's rule
    (`conv_transpose_pads`), with the kernel as it is
    (transpose_kernel=False). torch's `conv_transpose2d` correlates it,
    padded by k - 1 - p on both sides, with the kernel flipped in space;
    so the weight here is flax's kernel (kh, kw, in, out) flipped in both
    spatial axes and laid out (in, out, kh, kw) (`utils/flax_bridge.py`
    does that), the call takes the smaller of the two paddings of each
    axis, and the rows and columns that the other one adds are cropped
    (or, where lax pads past k - 1, zero rows added: the bias alone).
    `f32_sum` as `Conv2d`'s."""

    def __init__(self, cin: int, cout: int, k, s, dtype=torch.float32,
                 f32_sum: bool = False, padding: str = "SAME",
                 bias: bool = True):
        super().__init__()
        self.k, self.s, self.dtype = _pair(k), _pair(s), dtype
        self.padding = padding
        self.f32_sum = f32_sum
        self.weight = nn.Parameter(torch.empty(cin, cout, *self.k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        cin = self.weight.shape[0]
        lecun_(self.weight.data, self.k[0] * self.k[1] * cin, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias.data)

    def forward(self, x):
        crops = [tuple(k - 1 - p for p in conv_transpose_pads(k, s,
                                                               self.padding))
                 for k, s in zip(self.k, self.s)]
        p = tuple(max(0, min(c)) for c in crops)
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.f32_sum and x.device.type == "cpu":
            y = F.conv_transpose2d(x.to(torch.float32), w.to(torch.float32),
                                   stride=self.s, padding=p).to(self.dtype)
        else:
            y = F.conv_transpose2d(x, w, stride=self.s, padding=p)
        # crop (or zero-pad) each axis to lax's extent
        (ha, hb), (wa, wb) = [(a - q, b - q) for (a, b), q in zip(crops, p)]
        if min(ha, hb, wa, wb) < 0:
            y = F.pad(y, (max(0, -wa), max(0, -wb), max(0, -ha),
                          max(0, -hb)))
            ha, hb, wa, wb = (max(0, v) for v in (ha, hb, wa, wb))
        y = y[:, :, ha:y.shape[2] - hb, wa:y.shape[3] - wb]
        y = y.permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.silu`, x * sigmoid(x), with the sigmoid expanded as XLA
    expands it (`sigmoid_stepwise`): in bf16 every step of the sigmoid
    rounds to bf16, where `F.silu` rounds once and moves detections near a
    threshold. The product is returned in f32, not rounded: where its
    reader converts it to f32 (int8 quantization, calibration) the
    compiled JAX program skips that rounding, and every other reader
    rounds it to its own dtype first (`ConvBnSiLU` says which)."""
    return x.to(torch.float32) * sigmoid_stepwise(x).to(torch.float32)


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), `jax.image.resize(..., "nearest")`:
    output pixel i reads input floor((i + 0.5) / 2) = i // 2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Linear(nn.Linear):
    """Dense layer (flax `nn.Dense`), bias-free unless `bias`; `keep_f32`
    as `Conv2d`'s: a BatchNorm reads the product, which the compiled JAX
    program then keeps in f32 (with a bias: the product rounded to
    `dtype`, the bias added in f32)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 keep_f32: bool = False, bias: bool = False):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype
        self.keep_f32 = keep_f32

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         std: Optional[float] = None, init: str = "kaiming"):
        if std is not None:
            nn.init.normal_(self.weight.data, 0.0, std, generator=generator)
        elif init == "kaiming":
            kaiming_(self.weight.data, self.out_features, generator)
        else:
            lecun_(self.weight.data, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias.data)

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.bias is not None:
            y = F.linear(x, w)
            if self.keep_f32:
                return y.to(torch.float32) + self.bias.to(self.dtype).to(
                    torch.float32)
            return y + self.bias.to(self.dtype)
        if self.keep_f32:
            x, w = x.to(torch.float32), w.to(torch.float32)
        return F.linear(x, w)


# The process group whose ranks hold one global batch between them, while a
# data-parallel train step runs (`global_batch_stats`); None: this
# process's batch is the whole batch.
_STATS_GROUP = None


@contextlib.contextmanager
def global_batch_stats(group):
    """Within the block, train-mode BatchNorm and BatchRenorm take their
    statistics over the global batch of `group`'s ranks, as a mean over a
    batch-sharded array is a global mean under GSPMD (JAX mesh.py:11-12).
    `group` None (a mesh of size 1) leaves them as they are."""
    global _STATS_GROUP
    prev, _STATS_GROUP = _STATS_GROUP, group
    try:
        yield
    finally:
        _STATS_GROUP = prev


def _global_mean(xf: torch.Tensor, dims, *more: torch.Tensor):
    """Per-channel means over `dims` of the global batch, of `xf` and of
    each of `more` (same shape): one all-reduce of the local sums and the
    local count, through `torch.distributed.nn.functional.all_reduce` so
    that the gradient flows back to every rank's term."""
    import torch.distributed.nn.functional as dnn
    c = xf.shape[-1]
    count = torch.full((1,), float(xf.numel() // c), device=xf.device)
    s = dnn.all_reduce(torch.cat([t.sum(dims) for t in (xf, *more)]
                                 + [count]), group=_STATS_GROUP)
    return [s[i * c:(i + 1) * c] / s[-1] for i in range(1 + len(more))]


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax `nn.BatchNorm`, momentum 0.9
    unless `momentum`): f32 arithmetic, output in `dtype`.

    By default (flax's use_running_average) it normalizes with the
    running statistics. With `train` (flax's train=True) it takes the
    batch statistics as flax 0.12's `_compute_stats` does: in f32 over
    every axis but the last, mean and E[x^2], var = max(E[x^2] - mean^2,
    0), biased; it normalizes with them and folds the same biased var into
    the running var (ra = m ra + (1 - m) batch). Under
    `global_batch_stats` the mean and E[x^2] are those of the global
    batch: one all-reduce of the sums, the sums of squares and the count.
    `F.batch_norm` (and `nn.SyncBatchNorm`) fold the unbiased var and are
    not used. `use_scale` / `use_bias` False drop the scale / the bias, as
    flax's flags do."""

    def __init__(self, c: int, use_bias: bool = True, eps: float = 1e-5,
                 dtype=torch.float32, momentum: float = 0.9,
                 use_scale: bool = True):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(c)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool = False):
        xf = x.to(torch.float32)
        if train:
            dims = tuple(range(x.ndim - 1))
            if _STATS_GROUP is None:
                mean, mean2 = xf.mean(dims), torch.mean(xf * xf, dims)
            else:
                mean, mean2 = _global_mean(xf, dims, xf * xf)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # flax _normalize: y = (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps)
        y = (xf - mean) * (mul if self.weight is None else mul * self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def _f32_inv(v: float) -> float:
    """The f32 reciprocal of f32(v): XLA compiles a division by a constant
    into a multiplication by it."""
    return float(np.float32(1.0) / np.float32(v))


class BatchRenorm(nn.Module):
    """Batch renormalization over every axis but the last (flax
    `BatchRenorm`, Ioffe 2017), f32 arithmetic, output in `dtype`.

    Train mode: the batch's mean and two-pass biased variance
    mean((x - mean)^2); y = ((x - mean) / std) * r + d with r =
    clip(std / ra_std, 1 / r_max, r_max) and d = clip((mean - ra_mean) /
    ra_std, -d_max, d_max), both without a gradient; r_max relaxes 1 -> 3
    and d_max 0 -> 5 over `warmup_steps` steps after the first
    `warmup_steps` (t = clip((steps - w) / w, 0, 1)), so a fresh layer runs
    on plain batch statistics. The running statistics move as (1 - m) ra +
    m batch with m = 0.01 (the opposite convention of flax's BatchNorm
    momentum) and the int32 `steps` buffer counts the call, all in place on
    the device. Eval: (x - ra_mean) * rsqrt(ra_var + eps), then * scale +
    bias. Under `global_batch_stats` the mean and the two-pass variance
    are the global batch's (two all-reduces)."""

    momentum, eps = 0.01, 1e-5
    r_max_final, d_max_final, warmup_steps = 3.0, 5.0, 500

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("steps", torch.zeros((), dtype=torch.int32))

    def _limits(self):
        """(r_max, d_max) at the current `steps`, on the device."""
        w = self.warmup_steps
        t = torch.clamp((self.steps - w).to(torch.float32) * _f32_inv(w),
                        0.0, 1.0)
        return 1.0 + (self.r_max_final - 1.0) * t, self.d_max_final * t

    @torch.no_grad()
    def _update(self, mean, var):
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)
        self.steps.add_(1)

    def forward(self, x, train: bool = False):
        xf = x.to(torch.float32)
        if not train:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var
                                                       + self.eps)
        else:
            dims = tuple(range(x.ndim - 1))
            if _STATS_GROUP is None:
                mean = xf.mean(dims)
                var = torch.square(xf - mean).mean(dims)
            else:
                mean, = _global_mean(xf, dims)
                var, = _global_mean(torch.square(xf - mean), dims)
            std = torch.sqrt(var + self.eps)
            with torch.no_grad():
                ra_std = torch.sqrt(self.running_var + self.eps)
                r_max, d_max = self._limits()
                r = torch.clamp(std / ra_std, 1.0 / r_max, r_max)
                d = torch.clamp((mean - self.running_mean) / ra_std, -d_max,
                                d_max)
            y = ((xf - mean) / std) * r + d
            self._update(mean.detach(), var.detach())
        return (y * self.weight + self.bias).to(self.dtype)


class BatchRenormNonIID(BatchRenorm):
    """Batch renormalization for PK batches (flax `BatchRenormNonIID`):
    train mode takes the statistics of each group of `group_size`
    consecutive samples (one identity of a PK batch) over (K, H, W), renorm-
    corrected against the running statistics as `BatchRenorm` does; the
    samples past the last whole group (a ragged tail) are normalized by the
    mean of the groups' means and the mean of their stds. The running
    statistics fold the whole batch's mean and two-pass variance. Eval
    blends each sample's own spatial statistics into the running ones,
    (1 - eval_blend) ra + eval_blend inst, and normalizes by them."""

    eval_blend = 0.2

    def __init__(self, c: int, group_size: int = 4, dtype=torch.float32):
        super().__init__(c, dtype)
        self.group_size = group_size

    def forward(self, x, train: bool = False):
        xf = x.to(torch.float32)
        b, h, w, c = x.shape
        if not train:
            inst_mean = xf.mean((1, 2), keepdim=True)
            inst_var = torch.square(xf - inst_mean).mean((1, 2), keepdim=True)
            a = self.eval_blend
            mean = (1 - a) * self.running_mean + a * inst_mean
            var = (1 - a) * self.running_var + a * inst_var
            y = (xf - mean) * torch.rsqrt(var + self.eps)
            return (y * self.weight + self.bias).to(self.dtype)
        if _STATS_GROUP is not None:
            raise NotImplementedError(
                "BatchRenormNonIID has no global-batch form; no "
                "data-parallel loop trains it")
        k = min(self.group_size, b)
        g = b // k
        xg = xf[:g * k].reshape(g, k, h, w, c)
        mean_g = xg.mean((1, 2, 3), keepdim=True)
        var_g = torch.square(xg - mean_g).mean((1, 2, 3), keepdim=True)
        std_g = torch.sqrt(var_g + self.eps)
        with torch.no_grad():
            ra_std = torch.sqrt(self.running_var + self.eps)
            r_max, d_max = self._limits()
            r = torch.clamp(std_g / ra_std, 1.0 / r_max, r_max)
            d = torch.clamp((mean_g - self.running_mean) / ra_std, -d_max,
                            d_max)
        y = (((xg - mean_g) / std_g) * r + d).reshape(g * k, h, w, c)
        if b > g * k:
            tail = (xf[g * k:] - mean_g.mean(0)) / std_g.mean(0)
            y = torch.cat([y, tail], dim=0)
        with torch.no_grad():
            batch_mean = xf.mean((0, 1, 2))
            batch_var = torch.square(xf - batch_mean).mean((0, 1, 2))
        self._update(batch_mean, batch_var)
        return (y * self.weight + self.bias).to(self.dtype)


def make_norm2d(c: int, dtype=torch.float32, renorm: bool = False):
    """BatchNorm, or BatchRenorm with `renorm`, per channel over (N, H, W,
    C)."""
    return BatchRenorm(c, dtype=dtype) if renorm else BatchNorm(c,
                                                                 dtype=dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over every axis between the
    batch and the channels: (H, W) of an image, (T, H, W) of a clip."""

    def __init__(self, c: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.to(torch.float32)
        dims = tuple(range(1, x.ndim - 1))
        mean = xf.mean(dim=dims, keepdim=True)
        var = torch.square(xf - mean).mean(dim=dims, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(self.dtype)


class IBN(nn.Module):
    """IBN-a: InstanceNorm on the first half of the channels, BatchNorm
    (BatchRenorm with `renorm`) on the rest (channels last)."""

    def __init__(self, c: int, ratio: float = 0.5, dtype=torch.float32,
                 renorm: bool = False):
        super().__init__()
        self.half = int(c * ratio)
        self.IN = InstanceNorm(self.half, dtype=dtype)
        self.BN = make_norm2d(c - self.half, dtype=dtype, renorm=renorm)

    def forward(self, x, train: bool = False):
        return torch.cat([self.IN(x[..., :self.half]),
                          self.BN(x[..., self.half:], train)], dim=-1)


class SEBlock(nn.Module):
    """Squeeze-excitation gate: GAP (f32) -> fc1 -> ReLU -> fc2 -> sigmoid,
    returned as (N, 1, 1, C)."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        mip = max(8, c // 16)
        self.fc1 = Linear(c, mip, dtype)
        self.fc2 = Linear(mip, c, dtype)

    def forward(self, x):
        s = x.to(torch.float32).mean(dim=(1, 2)).to(self.dtype)
        s = torch.relu(self.fc1(s))
        return sigmoid_stepwise(self.fc2(s))[:, None, None, :]


class _StepwiseSigmoid(torch.autograd.Function):
    """`sigmoid_stepwise` with the gradient JAX takes for `lax.logistic`,
    g * (y * (1 - y)), each step rounded to y's dtype."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid_stepwise(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with every step rounded to x's dtype: XLA expands
    a bf16 `jax.nn.sigmoid` into exactly these bf16 ops, where
    `torch.sigmoid` rounds once (1 bf16 ulp apart on about a quarter of
    the values). Under autograd the gradient is JAX's (`_StepwiseSigmoid`);
    without it (serving, export) the plain ops run."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _StepwiseSigmoid.apply(x)
    return torch.reciprocal(1 + torch.exp(-x))


class GeM(nn.Module):
    """Generalized-mean pooling with learnable p over the axes `dims`:
    (N, H, W, C) -> (N, C)."""
    dims = (1, 2)

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.p = nn.Parameter(torch.tensor(p_init))

    def forward(self, x):
        # jnp.clip's maximum: at a tie with eps the gradient splits in half
        # there, where clamp's passes whole; eps filled on the device (a
        # copy from the host would wait for the device's queue)
        xf = torch.maximum(x.to(torch.float32),
                           torch.full((), self.eps, device=x.device))
        pooled = torch.mean(xf ** self.p, dim=self.dims) ** (1.0 / self.p)
        return pooled.to(self.dtype)


class GeM1D(GeM):
    """GeM over a token axis: (N, L, C) -> (N, C)."""
    dims = (1,)


class GeM3D(GeM):
    """GeM over a clip's (T, H, W): (N, T, H, W, C) -> (N, C)."""
    dims = (1, 2, 3)


def in_dtype(v: float, dtype) -> float:
    """The python float `v` rounded to `dtype` (a constant of a formula
    that JAX casts to the array's dtype before it multiplies)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`, which is `jax.nn.gelu` with its default
    approximate=True: x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))) / 2,
    not `F.gelu`'s erf default. Every step rounds to x's dtype and the
    constants are rounded to it first, as the compiled JAX program does
    in bf16 (`F.gelu(approximate="tanh")` rounds once)."""
    dt = x.dtype
    inner = x + in_dtype(0.044715, dt) * ((x * x) * x)
    t = torch.tanh(in_dtype(float(np.sqrt(2 / np.pi)), dt) * inner)
    return x * (0.5 * (1.0 + t))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in train mode: each element kept with
    probability 1 - rate and divided by it, the others 0. The mask is
    drawn on x's device from `generator`, never from the global
    generator, so a step is repeatable and reads nothing back to the
    host. Rate 0 is the identity, as in flax, and needs no generator."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator on "
                         "the input's device")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """The (before, after) zero padding of flax's padding="SAME" for a conv
    of kernel k and stride s over `size` pixels: ceil(size / s) outputs,
    the larger half after."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NHWC `x` padded as a "SAME" k x k / s conv pads it (nothing where
    s divides the size and k == s, as at the transformers' sizes)."""
    (t, b), (l, r) = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
    if t == b == l == r == 0:
        return x
    return F.pad(x, (0, 0, l, r, t, b))


def _fast_stats(xf: torch.Tensor, dims):
    """flax `_compute_stats` with its fast variance: mean and
    max(E[x^2] - mean^2, 0) over `dims`, kept as dims of size 1."""
    mean = xf.mean(dims, keepdim=True)
    var = torch.clamp(torch.mean(xf * xf, dims, keepdim=True) - mean * mean,
                      min=0.0)
    return mean, var


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (eps 1e-6, fast variance),
    f32 arithmetic, output in `dtype`; with `keep_f32` in f32, for a
    reader that converts it to f32 itself (a norm or a pooling), where the
    compiled JAX program skips the rounding to `dtype`."""

    def __init__(self, c: int, eps: float = 1e-6, dtype=torch.float32,
                 keep_f32: bool = False):
        super().__init__()
        self.eps, self.dtype, self.keep_f32 = eps, dtype, keep_f32
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean, var = _fast_stats(xf, (-1,))
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        y = y + self.bias
        return y if self.keep_f32 else y.to(self.dtype)


class GroupNorm1(nn.Module):
    """flax `nn.GroupNorm(num_groups=1)`: each sample's statistics over all
    of its axes (fast variance), a scale and bias per channel, f32."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean, var = _fast_stats(xf, tuple(range(1, x.ndim)))
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class LBN1D(nn.Module):
    """Split layer / batch norm over feature vectors (flax `LBN1D`):
    LayerNorm on the first `ratio` of the features, BatchNorm (BatchRenorm
    with `renorm`) over the batch on the rest."""

    def __init__(self, c: int, ratio: float = 0.5, dtype=torch.float32,
                 renorm: bool = False):
        super().__init__()
        self.half = int(c * ratio)
        self.LN = LayerNorm(self.half, dtype=dtype)
        self.BN = make_norm2d(c - self.half, dtype=dtype, renorm=renorm)

    def forward(self, x, train: bool = False):
        return torch.cat([self.LN(x[..., :self.half]),
                          self.BN(x[..., self.half:], train)], dim=-1)


class AttentionPooling(nn.Module):
    """CLIP-style attention pooling (flax `AttentionPooling`): the tokens'
    mean queries the tokens and itself over `num_heads` heads; (N, L, C)
    -> (N, C). The logits are computed in f32 and scaled by the f32
    reciprocal of sqrt(head width), as the compiled JAX program does."""

    def __init__(self, c: int, num_heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.heads, self.dtype = num_heads, dtype
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, Linear(c, c, dtype, bias=True))

    def forward(self, x):
        n, l, c = x.shape
        h, d = self.heads, c // self.heads
        mean = x.to(torch.float32).mean(1, keepdim=True).to(x.dtype)
        tokens = torch.cat([mean, x], dim=1)
        q = self.q(mean).reshape(n, 1, h, d)
        k = self.k(tokens).reshape(n, l + 1, h, d)
        v = self.v(tokens).reshape(n, l + 1, h, d)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k).to(torch.float32)
        att = torch.softmax(logits * _f32_inv(math.sqrt(d)), -1).to(
            self.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", att, v).reshape(n, 1, c)
        return self.proj(out)[:, 0]


class MetaAconC1D(nn.Module):
    """The ACON activation with a learned switch (flax `MetaAconC1D`):
    beta = sigmoid(bn2(fc2(bn1(fc1(x))))) (momentum 0.99 norms), d = (p1 -
    p2) x, out = d sigmoid(beta d) + p2 x."""

    def __init__(self, width: int, r: int = 16, dtype=torch.float32):
        super().__init__()
        hidden = max(r, width // r)
        self.fc1 = Linear(width, hidden, dtype, keep_f32=True, bias=True)
        self.bn1 = BatchNorm(hidden, dtype=dtype, momentum=0.99)
        self.fc2 = Linear(hidden, width, dtype, keep_f32=True, bias=True)
        self.bn2 = BatchNorm(width, dtype=dtype, momentum=0.99)
        self.p1 = nn.Parameter(torch.zeros(1, width))
        self.p2 = nn.Parameter(torch.zeros(1, width))

    def forward(self, x, train: bool = False):
        h = self.bn2(self.fc2(self.bn1(self.fc1(x), train)), train)
        beta = sigmoid_stepwise(h)
        p1, p2 = self.p1.to(x.dtype), self.p2.to(x.dtype)
        d = (p1 - p2) * x
        return d * sigmoid_stepwise(beta * d) + p2 * x


def conv3x3(cin: int, cout: int, stride: int = 1, dtype=torch.float32,
            keep_f32: bool = False):
    return Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype,
                  keep_f32=keep_f32)


def conv1x1(cin: int, cout: int, stride: int = 1, dtype=torch.float32,
            keep_f32: bool = False):
    return Conv2d(cin, cout, 1, stride=stride, padding=0, dtype=dtype,
                  keep_f32=keep_f32)


def max_pool_same(x, window: int = 3, stride: int = 2, padding: int = 1):
    """window x window max pool, NHWC, padded with -inf (torch-style
    padding 1 by default)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def max_pool3d(x):
    """flax `nn.max_pool(x, (1, 3, 3), strides=(1, 2, 2), padding=((0,
    0), (1, 1), (1, 1)))` on (N, T, H, W, C), padded with -inf: the window
    spans one frame, so each frame is pooled as an image."""
    n, t = x.shape[:2]
    y = max_pool_same(x.reshape(n * t, *x.shape[2:]))
    return y.reshape(n, t, *y.shape[1:])
