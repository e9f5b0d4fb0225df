"""PLR-OSNet's attention modules in PyTorch, NHWC: the per-position SE gate,
PAM position attention, their PAM -> SE composite, and MCA.

Counterpart of `reid_tpu/models/attention_modules.py`, with flax's module
names ("att1/pam/query", "att1/se/fc1", "gate_c"):

  * `SEModule`: no pooling, a gate for every position: 1x1 conv (bias)
    -> ReLU -> 1x1 conv (bias) -> sigmoid, times the input;
  * `PAMModule`: 1x1 query and key convs (bias) to C / 8 channels, the
    (HW x HW) energies and their softmax over keys, the softmax-weighted
    sum of the input's pixels, scaled by the f32 `gamma` (initialized to
    0, so a fresh module is BN(0) + x), a BatchNorm, plus the input;
  * `AttentionModule`: PAM then SE;
  * `MCALayer`: three gates from [std, mean] descriptors pooled over (H, W),
    (W, C) and (H, C), each a 3-tap 1-D conv (2 -> 1, no bias) and a
    sigmoid, the three gated copies averaged. No registered backbone of
    either package uses it.

The bf16 roundings are those of the compiled JAX program: the energies
and the weighted sum are bf16 products (f32 accumulation, one rounding),
the softmax as `_softmax_last` says, the BatchNorm reads gamma times the
weighted sum unrounded, a bf16 sigmoid rounds each step
(`layers.sigmoid_stepwise`), and MCA's division by 3 is a multiplication
by the f32 reciprocal of the bf16-rounded sum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d, kaiming_, sigmoid_stepwise

_F32_TINY = float(np.finfo(np.float32).tiny)


class SEModule(nn.Module):
    """Per-position channel gate (flax `SEModule`)."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, dtype=dtype,
                          bias=True)
        self.fc2 = Conv2d(channels // reduction, channels, 1, dtype=dtype,
                          bias=True)

    def forward(self, x):
        s = torch.relu(self.fc1(x))
        return x * sigmoid_stepwise(self.fc2(s))


class PAMModule(nn.Module):
    """Position attention with a learnable `gamma` (flax `PAMModule`)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.query = Conv2d(channels, channels // 8, 1, dtype=dtype,
                            bias=True)
        self.key = Conv2d(channels, channels // 8, 1, dtype=dtype, bias=True)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.bn = BatchNorm(channels, dtype=dtype)

    def forward(self, x, train: bool = False):
        n, h, w, c = x.shape
        q = self.query(x).reshape(n, h * w, -1)
        k = self.key(x).reshape(n, h * w, -1)
        energy = torch.bmm(q, k.transpose(1, 2))
        att = _softmax_last(energy)
        out = torch.bmm(att, x.reshape(n, h * w, c).to(att.dtype))
        # the BatchNorm reads gamma * out unrounded (f32)
        out = self.gamma.to(self.dtype).to(torch.float32) * out.reshape(
            n, h, w, c).to(torch.float32)
        return self.bn(out, train) + x


def _softmax_last(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax(x, axis=-1)` as the compiled JAX program computes it
    at x's dtype: d = x - max rounded to x's dtype, exp(d) in f32 with
    subnormal results flushed to 0 (XLA:CPU flushes them), summed
    unrounded and the sum rounded to x's dtype, then exp(d) rounded to
    x's dtype divided by that sum."""
    d = x - torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(d.to(torch.float32))
    e = torch.where(e < _F32_TINY, torch.zeros_like(e), e)
    return e.to(x.dtype) / e.sum(-1, keepdim=True).to(x.dtype)


class AttentionModule(nn.Module):
    """PAM -> SE (flax `AttentionModule`), PLR-OSNet's `att1` / `att2`."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.pam = PAMModule(channels, dtype)
        self.se = SEModule(channels, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.se(self.pam(x, train))


class Conv1d(nn.Conv1d):
    """flax `nn.Conv(features, (k,), padding=p, use_bias=False)` over
    (N, L, C); the weight (out, in, k) is flax's kernel (k, in, out)
    transposed."""

    def __init__(self, cin: int, cout: int, k: int, padding: int,
                 dtype=torch.float32):
        super().__init__(cin, cout, k, padding=padding, bias=False)
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_(self.weight.data, self.kernel_size[0] * self.out_channels,
                 generator)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2).to(self.dtype),
                     self.weight.to(self.dtype), padding=self.padding)
        return y.transpose(1, 2)


class MCALayer(nn.Module):
    """Multi-dimension collaborative attention (flax `MCALayer`)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("gate_c", "gate_h", "gate_w"):
            self.add_module(name, Conv1d(2, 1, 3, 1, dtype))

    def _stdmean(self, xf, axes):
        m = xf.mean(axes)
        d = xf - xf.mean(axes, keepdim=True)
        s = torch.sqrt(torch.square(d).mean(axes) + 1e-5)
        return torch.stack([s, m], dim=-1).to(self.dtype)

    def forward(self, x):
        xf = x.to(torch.float32)
        g_c = sigmoid_stepwise(self.gate_c(self._stdmean(xf, (1, 2))))
        out_c = x * g_c[:, None, None, :, 0]
        g_h = sigmoid_stepwise(self.gate_h(self._stdmean(xf, (2, 3))))
        out_h = x * g_h[:, :, None, :]
        g_w = sigmoid_stepwise(self.gate_w(self._stdmean(xf, (1, 3))))
        out_w = x * g_w[:, None, :, :]
        total = out_c + out_h + out_w
        third = float(np.float32(1.0) / np.float32(3.0))
        return (total.to(torch.float32) * third).to(total.dtype)

