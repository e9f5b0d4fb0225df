"""CenterNet-style anchor-free detector, NHWC.

Counterpart of `reid_tpu/models/detector.py`: `CenterNetLite` (a stride-4
trunk of conv-BN-ReLU stages, two transposed convs back up to stride 4 and
the center-heatmap / size / offset heads) in eval and train mode,
`decode_detections` (peak NMS by a 3x3 max-pool, then top-k), and the
training pieces: `make_centernet_targets` (Gaussian centre splats and the
size / offset targets on the stride-4 grid) and `detection_loss` (focal
heatmap loss + masked L1). Module names equal the flax ones, so a flax
variable path ("c1_conv/kernel") names the same parameter here
("c1_conv.weight").
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..tracking.pipeline import topk_indices
from ..utils.quantize import inv_f32
from .layers import (BatchNorm, Conv2d, ConvTranspose2d, max_pool_same,
                     sigmoid_stepwise)

_F32_TINY = float(torch.finfo(torch.float32).tiny)


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

    def _cbr(self, name, y, train):
        bn = getattr(self, f"{name}_bn")
        return torch.relu(bn(getattr(self, f"{name}_conv")(y), train))

    def forward(self, x, train: bool = False) -> Dict[str, torch.Tensor]:
        """Eval mode by default (running statistics); `train` normalizes
        with the batch's statistics and folds them into the running ones
        (flax's train=True, momentum 0.9)."""
        x = x.to(self.dtype)
        c1 = self._cbr("c1", x, train)
        c2 = self._cbr("c2", c1, train)
        c3 = self._cbr("c3", c2, train)
        c4 = self._cbr("c4", c3, train)
        u3 = self.up3(c4) + c3
        u2 = self.up2(u3) + c2
        feat = self._cbr("head", u2, train)
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


def make_centernet_targets(tlwh: torch.Tensor, valid: torch.Tensor,
                           image_hw: Tuple[int, int], stride: int = 4,
                           sigma_frac: float = 6.0):
    """(gt_heat (B,h,w), gt_wh (B,h,w,2), gt_offset (B,h,w,2), gt_mask
    (B,h,w) bool) on the stride-`stride` grid from padded boxes tlwh
    (B, D, 4) and valid (B, D): each valid box splats a Gaussian of sigma
    max((w + h) / (2 stride sigma_frac), 1) at its centre cell (the max
    over boxes), and writes its size / stride and sub-cell offset at that
    cell. As in the JAX module, invalid boxes scatter to column w, out of
    bounds, and are dropped; where two boxes share a cell the later one's
    values stay (`.at[].set` in XLA:CPU's order; on the card unordered).
    The splats' exp is torch's, within an ulp of XLA's."""
    b, d = valid.shape
    h, w = image_hw[0] // stride, image_hw[1] // stride
    tlwh = tlwh.to(torch.float32)
    valid = valid.to(torch.bool)
    cx = (tlwh[..., 0] + 0.5 * tlwh[..., 2]) / stride
    cy = (tlwh[..., 1] + 0.5 * tlwh[..., 3]) / stride
    ix = torch.clamp(torch.floor(cx), 0, w - 1)
    iy = torch.clamp(torch.floor(cy), 0, h - 1)
    # XLA divides by the constant as a multiply by its f32 reciprocal
    sigma = torch.clamp((tlwh[..., 2] + tlwh[..., 3])
                        * inv_f32(2 * stride * sigma_frac), min=1.0)
    dev = tlwh.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    g = torch.exp(-((ys - iy[..., None, None]) ** 2
                    + (xs - ix[..., None, None]) ** 2)
                  / (2.0 * sigma[..., None, None] ** 2))    # (B, D, h, w)
    # XLA flushes subnormal results to 0
    g = torch.where(valid[..., None, None] & (g >= _F32_TINY), g, 0.0)
    gt_heat = g.amax(dim=1)

    # one spare column w takes the invalid boxes' writes (no host read)
    bi = torch.arange(b, device=dev).repeat_interleave(d)
    yi = iy.reshape(-1).to(torch.int64)
    xi = torch.where(valid.reshape(-1), ix.reshape(-1).to(torch.int64), w)
    wh = torch.stack([tlwh[..., 2], tlwh[..., 3]], -1).reshape(-1, 2) / stride
    off = torch.stack([cx - ix, cy - iy], -1).reshape(-1, 2)
    gt_wh = torch.zeros((b, h, w + 1, 2), dtype=torch.float32, device=dev)
    gt_off = torch.zeros_like(gt_wh)
    gt_mask = torch.zeros((b, h, w + 1), dtype=torch.bool, device=dev)
    gt_wh[bi, yi, xi] = wh
    gt_off[bi, yi, xi] = off
    gt_mask[bi, yi, xi] = valid.reshape(-1)
    return gt_heat, gt_wh[:, :, :w], gt_off[:, :, :w], gt_mask[:, :, :w]


def detection_loss(outputs: Dict[str, torch.Tensor], gt_heat, gt_wh,
                   gt_offset, gt_mask, alpha: float = 2.0, beta: float = 4.0,
                   wh_weight: float = 0.1, off_weight: float = 1.0):
    """CenterNet's focal heatmap loss (positives where gt_heat >= 0.999)
    + masked L1 of size and offset, each over the positives' count (at
    least 1), in f32."""
    pred = sigmoid_stepwise(outputs["heat"][..., 0].to(torch.float32))
    pred = torch.clamp(pred, 1e-6, 1.0 - 1e-6)
    pos = (gt_heat >= 0.999).to(torch.float32)
    neg_w = (1.0 - gt_heat) ** beta
    loss_pos = -pos * ((1 - pred) ** alpha) * torch.log(pred)
    loss_neg = -(1 - pos) * neg_w * (pred ** alpha) * torch.log(1 - pred)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    hm_loss = (loss_pos.sum() + loss_neg.sum()) / n_pos
    m = gt_mask[..., None].to(torch.float32)
    wh_loss = (torch.abs(outputs["wh"].to(torch.float32) - gt_wh)
               * m).sum() / n_pos
    off_loss = (torch.abs(outputs["offset"].to(torch.float32) - gt_offset)
                * m).sum() / n_pos
    return hm_loss + wh_weight * wh_loss + off_weight * off_loss
