"""Swin transformer v1 / v2 with the U-Net fusion head, in PyTorch, NHWC.

Counterpart of `reid_tpu/models/swin.py`, with flax's module names
("stage2_block1_shift/attn/to_qkv", "merge3/linear", "stage4_align"):

  * the shadow feature stem: a 2x2/2 conv to 12 channels, `MixedNorm`,
    ReLU, a 2x2/2 conv to 48, ReLU, a dense layer to the hidden width
    ("sfe_fc"), and the SIE table (n_views, 1, 1, hidden) added x1.5 per
    camera. flax creates that table only when `init` saw a `cam`, so it
    exists here only in a model built with `sie=True`; the default build
    (the CLIs', `create_train_state`'s) has none and refuses a `cam`, as
    the flax model without the parameter does;
  * four stages of (regular, shifted) `SwinBlock` pairs, stages 2-4 after
    a `PatchMerging` (2x2 space-to-depth, then a dense layer);
  * `WindowAttention`: a cyclic roll by half a window for the shifted
    block, `to_qkv`, windows of ws x ws tokens a head; v1 scales q.k by
    head_dim^-0.5 and adds the relative-position table (2ws - 1, 2ws - 1);
    v2 takes the cosine of the L2-normalized q and k times exp(min(
    logit_scale, log 100)) and adds the log-spaced continuous position
    bias, a meta-MLP ("meta_fc1" 2 -> 384, ReLU, "meta_fc2" -> heads) run
    in f32 on a constant; the shifted block adds the -1e9 masks of the
    last window row and column; the softmax runs in f32 and its result in
    the dtype multiplies v; then `to_out`, `post_proj`, dropout and the
    roll back;
  * `SwinBlock`: pre-norm (v1) or post-norm (v2) attention and a 4x MLP
    with the tanh gelu;
  * the head: the stem through an 8x8/8 conv ("img_channel_align") added
    to stage 4, three 4x4/2 "SAME" transposed convs up to stage 1's grid,
    each added to its stage, then a LayerNorm over the tokens, `GeM1D`,
    a BNNeck without bias and the bias-free `mlp_head`.

The grid must halve three times into whole windows: at window 7 that is
448x224 or 224x224 (224x112 fails in both packages, in `PatchMerging`).
The attention's output dropout (0.1, a constant in the flax module) is
`dropout` here, so that a test can turn it off on both sides; it draws
from the `rng` generator passed to the forward.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .layers import (BatchNorm, Conv2d, ConvTranspose2d, GeM1D, LayerNorm,
                     Linear, dropout, gelu, in_dtype, pad_same)
from .vit import MixedNorm, residual_sum, trunc_normal_, view_index

_NEG = -1e9


def shift_masks(window_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The additive masks of the shifted pass: the last window row's
    (upper / lower halves apart) and the last window column's."""
    ws, d = window_size, window_size // 2
    ul = np.zeros((ws * ws, ws * ws), np.float32)
    ul[-d * ws:, :-d * ws] = _NEG
    ul[:-d * ws, -d * ws:] = _NEG
    lr = np.zeros((ws, ws, ws, ws), np.float32)
    lr[:, -d:, :, :-d] = _NEG
    lr[:, :-d, :, -d:] = _NEG
    return ul, lr.reshape(ws * ws, ws * ws)


def relative_indices(window_size: int) -> np.ndarray:
    """(L, L, 2) offsets between the window's tokens, L = ws^2."""
    idx = np.array([[x, y] for x in range(window_size)
                    for y in range(window_size)])
    return idx[None, :, :] - idx[:, None, :]


def _l2n(t: torch.Tensor) -> torch.Tensor:
    """t / max(|t| in f32, 1e-12), the norm cast to t's dtype."""
    norm = torch.linalg.vector_norm(t.to(torch.float32), dim=-1,
                                    keepdim=True)
    return t / torch.clamp(norm, min=1e-12).to(t.dtype)


class WindowAttention(nn.Module):
    """Window multi-head self-attention, v1 or v2 (flax
    `WindowAttention`), on (B, H, W, C)."""

    def __init__(self, dim: int, heads: int, head_dim: int, shifted: bool,
                 window_size: int, version: str = "v1",
                 dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        if version not in ("v1", "v2"):
            raise ValueError(f"version '{version}' is not v1 or v2")
        self.heads, self.head_dim = heads, head_dim
        self.shifted, self.ws, self.version = shifted, window_size, version
        self.dtype, self.rate = dtype, dropout
        inner = heads * head_dim
        ws = window_size
        self.to_qkv = Linear(dim, inner * 3, dtype)
        rel = relative_indices(ws)
        if version == "v2":
            self.logit_scale = nn.Parameter(
                torch.full((heads,), math.log(10.0)))
            r = rel.reshape(-1, 2).astype(np.float32)
            self.register_buffer("rel_log", torch.from_numpy(
                np.sign(r) * np.log1p(np.abs(r))), persistent=False)
            self.meta_fc1 = Linear(2, 384, torch.float32, bias=True)
            self.meta_fc2 = Linear(384, heads, torch.float32, bias=True)
        else:
            self.pos_embedding = nn.Parameter(
                torch.zeros(2 * ws - 1, 2 * ws - 1))
            self.register_buffer("rel_idx", torch.from_numpy(
                (rel + ws - 1).astype(np.int64)), persistent=False)
        if shifted:
            ul, lr = shift_masks(ws)
            self.register_buffer("mask_ul", torch.from_numpy(ul),
                                 persistent=False)
            self.register_buffer("mask_lr", torch.from_numpy(lr),
                                 persistent=False)
        self.to_out = Linear(inner, dim, dtype, bias=True)
        # v2's post-norm reads this product's biased sum in f32, but for
        # the roll back, which takes the rounded sum
        self.post_proj = Linear(dim, dim, dtype, bias=True,
                                keep_f32=version == "v2" and not shifted)

    def _bias(self) -> torch.Tensor:
        """The (heads or 1, L, L) position bias, f32."""
        ws = self.ws
        if self.version == "v1":
            ri = self.rel_idx
            return self.pos_embedding[ri[..., 0], ri[..., 1]][None]
        mlp = torch.relu(self.meta_fc1(self.rel_log))
        return self.meta_fc2(mlp).T.reshape(self.heads, ws * ws, ws * ws)

    def _mask(self, nw_h: int, nw_w: int) -> torch.Tensor:
        """(windows, L, L): the masks of the last window row and column."""
        win = torch.arange(nw_h * nw_w, device=self.mask_ul.device)
        ul_apply = (win // nw_w == nw_h - 1).to(torch.float32)
        lr_apply = (win % nw_w == nw_w - 1).to(torch.float32)
        return (ul_apply[:, None, None] * self.mask_ul[None]
                + lr_apply[:, None, None] * self.mask_lr[None])

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        dt, ws, h, hd = self.dtype, self.ws, self.heads, self.head_dim
        b, n_h, n_w, _ = x.shape
        disp = ws // 2
        if self.shifted:
            x = torch.roll(x, (-disp, -disp), dims=(1, 2))
        qkv = self.to_qkv(x)
        nw_h, nw_w = n_h // ws, n_w // ws

        def to_windows(t):
            t = t.reshape(b, nw_h, ws, nw_w, ws, h, hd)
            return t.permute(0, 5, 1, 3, 2, 4, 6).reshape(
                b, h, nw_h * nw_w, ws * ws, hd)

        q, k, v = (to_windows(t) for t in torch.chunk(qkv, 3, dim=-1))
        if self.version == "v2":
            dots = torch.einsum("bhwid,bhwjd->bhwij", _l2n(q), _l2n(k))
            scale = torch.exp(torch.clamp(self.logit_scale,
                                          max=math.log(100.0)))
            dots = dots * scale[None, :, None, None, None].to(dt)
        else:
            dots = torch.einsum("bhwid,bhwjd->bhwij", q, k) * in_dtype(
                hd ** -0.5, dt)
        terms = [self._bias()[None, :, None].to(dt)]
        if self.shifted:
            terms.append(self._mask(nw_h, nw_w)[None, None].to(dt))
        for t in terms[:-1]:
            dots = dots + t
        # the softmax reads the last sum in f32, before its rounding to dt
        logits = dots.to(torch.float32) + terms[-1].to(torch.float32)
        att = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhwij,bhwjd->bhwid", att, v)
        out = out.reshape(b, h, nw_h, nw_w, ws, ws, hd)
        out = out.permute(0, 2, 4, 3, 5, 1, 6).reshape(b, n_h, n_w, h * hd)
        out = self.post_proj(self.to_out(out))
        out = dropout(out, self.rate if train else 0.0, rng)
        if self.shifted:
            out = torch.roll(out, (disp, disp), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    """Residual attention + MLP: pre-norm in v1, post-norm in v2."""

    def __init__(self, dim: int, heads: int, head_dim: int, shifted: bool,
                 window_size: int, version: str = "v1",
                 dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.version = version
        self.attn = WindowAttention(dim, heads, head_dim, shifted,
                                    window_size, version, dtype, dropout)
        self.ln1 = LayerNorm(dim, dtype=dtype)
        self.fc1 = Linear(dim, dim * 4, dtype, bias=True)
        # v2's ln2 reads fc2's biased sum in f32, as ln1 reads post_proj's
        self.fc2 = Linear(dim * 4, dim, dtype, bias=True,
                          keep_f32=version == "v2")
        self.ln2 = LayerNorm(dim, dtype=dtype)

    def _mlp(self, y):
        return self.fc2(gelu(self.fc1(y)))

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """`x` in the dtype or, from a v1 block, its unrounded f32 sum;
        v1 returns its output so too (the next block's ln1 reads it
        unrounded, as in `TransformerBlock`), v2 in the dtype."""
        dt = self.ln1.dtype
        xr = x.to(dt)
        if self.version == "v2":
            xr = xr + self.ln1(self.attn(xr, train, rng))
            return xr + self.ln2(self._mlp(xr))
        s = residual_sum(xr, self.attn(self.ln1(x), train, rng))
        return residual_sum(s.to(dt), self._mlp(self.ln2(s)))


class PatchMerging(nn.Module):
    """f x f space-to-depth, then a dense layer (flax `PatchMerging`)."""

    def __init__(self, cin: int, out_channels: int, factor: int,
                 dtype=torch.float32):
        super().__init__()
        self.f = factor
        self.linear = Linear(cin * factor * factor, out_channels, dtype,
                             bias=True)

    def forward(self, x):
        b, h, w, c = x.shape
        f = self.f
        x = x.reshape(b, h // f, f, w // f, f, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)
        return self.linear(x)


class SwinTransformer(nn.Module):
    """Swin-T with the U-Net fusion head (flax `SwinTransformer`)."""

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 num_seqs: int = 0, hidden_dim: int = 96,
                 layers: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), head_dim: int = 32,
                 window_size: int = 7, version: str = "v1",
                 side_info: bool = True, sie_factor: float = 1.5,
                 sie: bool = False, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.sie_factor = dtype, sie_factor
        hd = hidden_dim
        self.sfe_conv1 = Conv2d(3, 12, 2, stride=2, dtype=dtype, bias=True,
                                f32_sum=True)
        self.sfe_norm = MixedNorm(12, dtype)
        self.sfe_conv2 = Conv2d(12, 48, 2, stride=2, dtype=dtype, bias=True,
                                f32_sum=True)
        self.sfe_fc = Linear(48, hd, dtype, bias=True)
        self.n_views = max(num_cams, 1) * max(num_seqs, 1)
        self.side_info_embedding = nn.Parameter(
            torch.zeros(self.n_views, 1, 1, hd)) \
            if sie and side_info and self.n_views > 1 else None
        dims = [hd, hd * 2, hd * 4, hd * 8]
        self.stage_names = []
        for s in range(4):
            if s > 0:
                self.add_module(f"merge{s}", PatchMerging(
                    dims[s - 1], dims[s], 2, dtype))
            names = []
            for i in range(layers[s] // 2):
                for kind, shifted in (("reg", False), ("shift", True)):
                    name = f"stage{s}_block{i}_{kind}"
                    self.add_module(name, SwinBlock(
                        dims[s], heads[s], head_dim, shifted, window_size,
                        version, dtype, dropout))
                    names.append(name)
            self.stage_names.append(names)
        self.img_channel_align = Conv2d(hd, hd * 8, 8, stride=8, dtype=dtype,
                                        bias=True, f32_sum=True)
        self.stage4_align = ConvTranspose2d(hd * 8, hd * 4, 4, 2, dtype, True)
        self.stage3_align = ConvTranspose2d(hd * 4, hd * 2, 4, 2, dtype, True)
        self.stage2_align = ConvTranspose2d(hd * 2, hd, 4, 2, dtype, True)
        self.norm = LayerNorm(hd, eps=1e-6, dtype=dtype, keep_f32=True)
        self.gem = GeM1D(dtype=dtype)
        self.bottleneck = BatchNorm(hd, use_bias=False, dtype=dtype)
        self.mlp_head = Linear(hd, num_classes, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initializers, drawn from `generator`: lecun for the convs,
        the transposed convs and the meta-MLPs, truncated normal(0.02) for
        the other dense layers and the tables, normal(0.001) for the
        head; biases 0, logit scales log 10."""
        for m in self.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                if isinstance(m, Conv2d):
                    m.reset_parameters(generator, init="lecun")
                else:
                    m.reset_parameters(generator)
            elif isinstance(m, WindowAttention):
                if m.version == "v1":
                    trunc_normal_(m.pos_embedding, generator)
                else:
                    m.meta_fc1.reset_parameters(generator, init="lecun")
                    m.meta_fc2.reset_parameters(generator, init="lecun")
        for name, m in self.named_modules():
            if isinstance(m, Linear) and m is not self.mlp_head \
                    and "meta_fc" not in name:
                trunc_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        if self.side_info_embedding is not None:
            trunc_normal_(self.side_info_embedding, generator)
        self.mlp_head.reset_parameters(generator, std=0.001)
        return self

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False, rng: Optional[torch.Generator] = None):
        dt = self.dtype
        x = x.to(dt)
        y = torch.relu(self.sfe_norm(self.sfe_conv1(pad_same(x, 2, 2)),
                                     train))
        y = torch.relu(self.sfe_conv2(pad_same(y, 2, 2)))
        y = self.sfe_fc(y)
        if cam is not None and self.n_views > 1:
            if self.side_info_embedding is None:
                raise ValueError(
                    "this Swin was built without its SIE table (sie=False, "
                    "as flax's init without a cam): it takes no cam")
            sie = self.side_info_embedding.to(dt)[view_index(cam,
                                                             self.n_views)]
            y = y + self.sie_factor * sie
        stem = y
        outs = []
        for s, names in enumerate(self.stage_names):
            if s > 0:
                y = getattr(self, f"merge{s}")(y)
            for name in names:
                y = getattr(self, name)(y, train, rng)
            outs.append(y.to(dt))
        fused = outs[3] + self.img_channel_align(pad_same(stem, 8, 8))
        fused = self.stage4_align(fused) + outs[2]
        fused = self.stage3_align(fused) + outs[1]
        # the norm reads the last sum unrounded and the pooling the norm's
        # f32 output (the pooled feature is rounded)
        fused = residual_sum(self.stage2_align(fused), outs[0])
        tokens = self.norm(fused.reshape(fused.shape[0], -1,
                                         fused.shape[-1]))
        feat = self.gem(tokens)
        bn = self.bottleneck(feat, train)
        logits = self.mlp_head(bn)
        return (feat.to(dt) if train else bn), logits
