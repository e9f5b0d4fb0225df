"""Model primitives of SERes18-IBN in PyTorch, NHWC like the JAX package.

Counterparts of `reid_tpu/models/layers.py`: `InstanceNorm`, `IBN`,
`SEBlock`, `GeM`, BatchNorm through `make_norm2d` (eval mode; BatchRenorm is
not ported), `conv3x3` / `conv1x1` and `max_pool_same`; and for the
detectors flax's `nn.silu`, `nn.ConvTranspose(padding="SAME")` and the
2x nearest `jax.image.resize`. Activations are
(N, H, W, C) at every public function, as in the flax modules; a conv
permutes to PyTorch's NCHW view of the same memory (channels-last), so no
copy is made. Each module computes at its `dtype` and keeps its parameters
in f32, casting at the points flax does: convs and dense layers cast their
input and kernel to `dtype`, norms and pooling compute in f32 and return
`dtype`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


class Conv2d(nn.Conv2d):
    """Conv on NHWC activations (flax `nn.Conv` semantics), bias-free
    unless `bias`; a bias is added in `dtype`, as flax adds it.

    `keep_f32`: the result is read in f32 (a BatchNorm follows, or the
    caller casts it to f32), and the compiled JAX program then skips the
    last rounding to `dtype` (XLA keeps the excess precision): the conv of
    the `dtype`-rounded input and kernel is returned in f32 without a
    bias, and with one the product is rounded to `dtype` and the bias
    added in f32."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, bias: bool = False,
                 keep_f32: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.dtype = dtype
        self.keep_f32 = keep_f32

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         init: str = "kaiming"):
        k = self.kernel_size[0] * self.kernel_size[1]
        if init == "kaiming":
            kaiming_(self.weight.data, k * self.out_channels, generator)
        else:
            lecun_(self.weight.data, k * self.in_channels, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias.data)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.keep_f32:
            x, w = x.to(torch.float32), w.to(torch.float32)
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is None:
            return y
        if self.keep_f32:
            return y.to(self.dtype).to(torch.float32) + self.bias.to(
                self.dtype).to(torch.float32)
        return y + self.bias.to(self.dtype)


def conv_transpose_same_pads(k: int, s: int) -> Tuple[int, int]:
    """The (before, after) padding that `jax.lax.conv_transpose` gives
    the stride-dilated input for padding="SAME": k + s - 2 in all, the
    larger half before (`lax._conv_transpose_padding`)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTranspose2d(nn.Module):
    """flax `nn.ConvTranspose(ch, (k, k), strides=(s, s), padding="SAME")`
    with its bias, on NHWC activations.

    flax correlates the stride-dilated input, padded by
    `conv_transpose_same_pads`, with the kernel as it is
    (transpose_kernel=False). torch's `conv_transpose2d` correlates it,
    padded by k - 1 - p on both sides, with the kernel flipped in space;
    so the weight here is flax's kernel (k, k, in, out) flipped in both
    spatial axes and laid out (in, out, k, k) (`utils/flax_bridge.py`
    does that), the call takes the smaller of the two paddings, and the
    rows and columns that the other one adds are cropped."""

    def __init__(self, cin: int, cout: int, k: int, s: int,
                 dtype=torch.float32):
        super().__init__()
        self.k, self.s, self.dtype = k, s, dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        cin = self.weight.shape[0]
        lecun_(self.weight.data, self.k * self.k * cin, generator)
        nn.init.zeros_(self.bias.data)

    def forward(self, x):
        pad_a, pad_b = conv_transpose_same_pads(self.k, self.s)
        crop_a, crop_b = self.k - 1 - pad_a, self.k - 1 - pad_b
        p = min(crop_a, crop_b)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(self.dtype),
                               self.weight.to(self.dtype), stride=self.s,
                               padding=p)
        h, w = y.shape[2], y.shape[3]
        y = y[:, :, crop_a - p:h - (crop_b - p), crop_a - p:w - (crop_b - p)]
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


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
    """Bias-free dense layer (flax `nn.Dense(use_bias=False)`)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__(cin, cout, bias=False)
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         std: Optional[float] = None):
        if std is None:
            kaiming_(self.weight.data, self.out_features, generator)
        else:
            nn.init.normal_(self.weight.data, 0.0, std, generator=generator)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis (flax `nn.BatchNorm` with
    use_running_average): f32 arithmetic, output in `dtype`."""

    def __init__(self, c: int, use_bias: bool = True, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        # flax _normalize: y = (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def make_norm2d(c: int, dtype=torch.float32) -> BatchNorm:
    """BatchNorm over (N, H, W, C) per channel (the renorm=False branch)."""
    return BatchNorm(c, dtype=dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the spatial axes."""

    def __init__(self, c: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(1, 2), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(self.dtype)


class IBN(nn.Module):
    """IBN-a: InstanceNorm on the first half of the channels, BatchNorm on
    the rest (channels last)."""

    def __init__(self, c: int, ratio: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.half = int(c * ratio)
        self.IN = InstanceNorm(self.half, dtype=dtype)
        self.BN = make_norm2d(c - self.half, dtype=dtype)

    def forward(self, x):
        return torch.cat([self.IN(x[..., :self.half]),
                          self.BN(x[..., self.half:])], dim=-1)


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


def sigmoid_stepwise(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with every step rounded to x's dtype: XLA expands
    a bf16 `jax.nn.sigmoid` into exactly these bf16 ops, where
    `torch.sigmoid` rounds once (1 bf16 ulp apart on about a quarter of
    the values)."""
    return torch.reciprocal(1 + torch.exp(-x))


class GeM(nn.Module):
    """Generalized-mean pooling with learnable p: (N, H, W, C) -> (N, C)."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.p = nn.Parameter(torch.tensor(p_init))

    def forward(self, x):
        xf = torch.clamp(x.to(torch.float32), min=self.eps)
        pooled = torch.mean(xf ** self.p, dim=(1, 2)) ** (1.0 / self.p)
        return pooled.to(self.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1, dtype=torch.float32):
    return Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype)


def conv1x1(cin: int, cout: int, stride: int = 1, dtype=torch.float32):
    return Conv2d(cin, cout, 1, stride=stride, padding=0, dtype=dtype)


def max_pool_same(x, window: int = 3, stride: int = 2, padding: int = 1):
    """window x window max pool, NHWC, padded with -inf (torch-style
    padding 1 by default)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding=padding)
    return y.permute(0, 2, 3, 1)
