"""CenterNet-style anchor-free detector, eval mode, NHWC.

Counterpart of `reid_tpu/models/detector.py`: `CenterNetLite` (a stride-4
trunk of conv-BN-ReLU stages, two transposed convs back up to stride 4 and
the center-heatmap / size / offset heads) and `decode_detections` (peak
NMS by a 3x3 max-pool, then top-k). Module names equal the flax ones, so
a flax variable path ("c1_conv/kernel") names the same parameter here
("c1_conv.weight"). The training pieces (`make_centernet_targets`,
`detection_loss`) are not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..tracking.pipeline import topk_indices
from .layers import (BatchNorm, Conv2d, ConvTranspose2d, max_pool_same,
                     sigmoid_stepwise)


class CenterNetLite(nn.Module):
    """Small hourglass-free trunk (stride 4) + center/size/offset heads;
    returns {"heat": (B,H/4,W/4,1), "wh": (..,2), "offset": (..,2)} in
    f32 (`Conv2d.keep_f32`)."""

    def __init__(self, base: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for name, ch, stride in (("c1", base, 2), ("c2", base * 2, 2),
                                 ("c3", base * 4, 2), ("c4", base * 8, 2),
                                 ("head", base * 2, 1)):
            if name == "head":
                cin = base * 2
            self.add_module(f"{name}_conv", Conv2d(cin, ch, 3, stride, 1,
                                                   dtype, keep_f32=True))
            self.add_module(f"{name}_bn", BatchNorm(ch, dtype=dtype))
            cin = ch
        self.up3 = ConvTranspose2d(base * 8, base * 4, 4, 2, dtype)
        self.up2 = ConvTranspose2d(base * 4, base * 2, 4, 2, dtype)
        # the heads are read in f32 (`decode_detections`)
        self.hm = Conv2d(base * 2, 1, 1, dtype=dtype, bias=True,
                         keep_f32=True)
        self.wh = Conv2d(base * 2, 2, 1, dtype=dtype, bias=True,
                         keep_f32=True)
        self.off = Conv2d(base * 2, 2, 1, dtype=dtype, bias=True,
                          keep_f32=True)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's initializers, drawn from `generator`:
        kaiming for the trunk convs, lecun_normal for the transposed convs
        and the heads, the heatmap bias at the focal prior -2.19."""
        for name in ("c1", "c2", "c3", "c4", "head"):
            getattr(self, f"{name}_conv").reset_parameters(generator)
        self.up3.reset_parameters(generator)
        self.up2.reset_parameters(generator)
        for m in (self.hm, self.wh, self.off):
            m.reset_parameters(generator, init="lecun")
        nn.init.constant_(self.hm.bias, -2.19)
        return self

    def _cbr(self, name, y):
        bn = getattr(self, f"{name}_bn")
        return torch.relu(bn(getattr(self, f"{name}_conv")(y)))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        c1 = self._cbr("c1", x)
        c2 = self._cbr("c2", c1)
        c3 = self._cbr("c3", c2)
        c4 = self._cbr("c4", c3)
        u3 = self.up3(c4) + c3
        u2 = self.up2(u3) + c2
        feat = self._cbr("head", u2)
        return {"heat": self.hm(feat), "wh": self.wh(feat),
                "offset": self.off(feat)}


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis,
    ties to the lower index, as `jax.lax.top_k` keeps them."""
    idx = topk_indices(x, k)
    return torch.gather(x, -1, idx), idx


def decode_detections(outputs: Dict[str, torch.Tensor], max_dets: int = 64,
                      stride: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heatmap -> (tlwh (B, max_dets, 4), scores (B, max_dets)): keep the
    maxima of the sigmoid heatmap under a 3x3 max-pool padded with -inf,
    then the top `max_dets` in (score, index) order."""
    heat = sigmoid_stepwise(outputs["heat"][..., 0].to(torch.float32))
    b, h, w = heat.shape
    pooled = max_pool_same(heat[..., None], 3, 1)[..., 0]
    peaks = torch.where(heat >= pooled, heat, 0.0)
    scores, idx = topk_stable(peaks.reshape(b, h * w), max_dets)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)

    def gather(t):
        t = t.to(torch.float32).reshape(b, h * w, 2)
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, 2))
    wh = gather(outputs["wh"]) * stride
    off = gather(outputs["offset"])
    cx = (xs + off[..., 0]) * stride
    cy = (ys + off[..., 1]) * stride
    tlwh = torch.stack([cx - 0.5 * wh[..., 0], cy - 0.5 * wh[..., 1],
                        wh[..., 0], wh[..., 1]], dim=-1)
    return tlwh, scores
