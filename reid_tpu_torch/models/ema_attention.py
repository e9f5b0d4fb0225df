"""EMA (efficient multi-scale attention) in PyTorch, NHWC: EMARes18's
block attention.

Counterpart of `reid_tpu/models/ema_attention.py`, with the same data
flow. The input (N, H, W, C) is reshaped row-major into G = min(32, C)
samples a image, (N G, H, W, C / G). The mean strips over W and over H go
through one 1x1 conv (with bias) and become two sigmoid gates; the gated
input's `GroupNorm(1)` (f32, fast variance) is x1, the 3x3 conv (with
bias) of the reshaped input is x2; each one's softmaxed spatial mean
weighs the other's pixels, and the sum of the two weightings gates the
input through a last sigmoid. Module names equal the flax ones
("ema_att/conv1x1", "ema_att/gn", "ema_att/conv3x3").

Roundings of the compiled JAX program, kept here: the strips are cast to
`dtype` before their conv, and both convs' products are read in f32
(`keep_f32`: the product rounded to `dtype`, the bias added in f32); the
rest runs in f32 and the output is cast to the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv2d, GroupNorm1, sigmoid_stepwise


class EMAttention(nn.Module):
    def __init__(self, c: int, factor: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.groups = min(factor, c)
        cg = c // self.groups
        self.conv1x1 = Conv2d(cg, cg, 1, dtype=dtype, bias=True,
                              keep_f32=True)
        self.gn = GroupNorm1(cg)
        self.conv3x3 = Conv2d(cg, cg, 3, padding=1, dtype=dtype, bias=True,
                              keep_f32=True)

    def forward(self, x, train: bool = False):
        n, h, w, c = x.shape
        ng = n * self.groups
        xg = x.reshape(ng, h, w, c // self.groups)
        xf = xg.to(torch.float32)
        x_h = xf.mean(2)                                  # (NG, H, Cg)
        x_w = xf.mean(1)                                  # (NG, W, Cg)
        hw = torch.cat([x_h, x_w], dim=1)[:, :, None, :]
        hw = self.conv1x1(hw.to(self.dtype)).to(torch.float32)
        gh, gw = hw[:, :h, 0, :], hw[:, h:, 0, :]
        gated = xf * sigmoid_stepwise(gh)[:, :, None, :] \
            * sigmoid_stepwise(gw)[:, None, :, :]
        x1 = self.gn(gated)
        x2 = self.conv3x3(xg).to(torch.float32)
        d1 = torch.softmax(x1.mean((1, 2)), dim=-1)       # (NG, Cg)
        d2 = torch.softmax(x2.mean((1, 2)), dim=-1)
        f1 = x2.reshape(ng, h * w, -1)
        f2 = x1.reshape(ng, h * w, -1)
        weights = (torch.einsum("nc,nlc->nl", d1, f1)
                   + torch.einsum("nc,nlc->nl", d2, f2)).reshape(ng, h, w, 1)
        out = xf * sigmoid_stepwise(weights)
        return out.reshape(n, h, w, c).to(x.dtype)
