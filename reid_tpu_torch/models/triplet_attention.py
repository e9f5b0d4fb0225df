"""Triplet attention in PyTorch, NHWC: CARes18's block attention.

Counterpart of `reid_tpu/models/triplet_attention.py`. Each of three gates
pools the block's output over one axis into a 2-channel map [std, mean]
(the unbiased std), runs a 7x7 conv (2 -> 1, no bias), a BatchNorm with
momentum 0.99 and a sigmoid over it, and scales the input by the gate:
cw pools over H and gates over (W, C), hc pools over W and gates over
(H, C), hw pools over C and gates over (H, W). The output is the mean of
the three gated tensors. Module names equal the flax ones
("triplet_att/cw/conv").

Roundings of the compiled JAX program, kept here: the pooled map is cast
to `dtype` (user code); the gate conv's product reaches its BatchNorm in
f32 (`keep_f32`); a bf16 sigmoid rounds each step (`sigmoid_stepwise`);
the division of the variance by N - 1 and of the sum by 3 are
multiplications by the f32 reciprocal, the latter of the `dtype`-rounded
sum.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .layers import BatchNorm, Conv2d, sigmoid_stepwise


def zpool(x: torch.Tensor, axis: int, dtype) -> torch.Tensor:
    """[std, mean] over `axis` (std unbiased, N - 1) of the f32 input,
    stacked on a new last axis and cast to `dtype`."""
    xf = x.to(torch.float32)
    mean = xf.mean(axis)
    n = x.shape[axis]
    ss = torch.square(xf - mean.unsqueeze(axis)).sum(axis)
    var = ss * float(np.float32(1.0) / np.float32(max(n - 1, 1)))
    return torch.stack([torch.sqrt(var), mean], dim=-1).to(dtype)


class AttentionGate(nn.Module):
    """(N, A, B, 2) pooled map -> (N, A, B, 1) gate: 7x7 conv -> BN
    (momentum 0.99) -> sigmoid."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3, dtype=dtype, keep_f32=True)
        self.bn = BatchNorm(1, dtype=dtype, momentum=0.99)

    def forward(self, x2d, train: bool = False):
        return sigmoid_stepwise(self.bn(self.conv(x2d), train))


class TripletAttention(nn.Module):
    """x (N, H, W, C) -> the mean of its three gated copies."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cw = AttentionGate(dtype)
        self.hc = AttentionGate(dtype)
        self.hw = AttentionGate(dtype)

    def forward(self, x, train: bool = False):
        dt = self.dtype
        g_cw = self.cw(zpool(x, 1, dt), train)            # (N, W, C, 1)
        out_cw = x * g_cw.permute(0, 3, 1, 2)
        g_hc = self.hc(zpool(x, 2, dt), train)            # (N, H, C, 1)
        out_hc = x * g_hc.permute(0, 1, 3, 2)
        g_hw = self.hw(zpool(x, 3, dt), train)            # (N, H, W, 1)
        out_hw = x * g_hw
        total = out_cw + out_hc + out_hw
        third = float(np.float32(1.0) / np.float32(3.0))
        return (total.to(torch.float32) * third).to(total.dtype)
