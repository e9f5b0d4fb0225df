"""ViT-t with the side-information embedding (SIE) in PyTorch, NHWC.

Counterpart of `reid_tpu/models/vit.py`, with flax's module names
("stem/mn1/in", "block3/attn/query", "to_latent"):

  * `MixedNorm`: InstanceNorm ("in") on the first half of the channels,
    BatchNorm ("bn") on the rest;
  * `ConvStem`: a 7x7/2 conv, two 3x3 convs (MixedNorm, MixedNorm, then
    BatchNorm, each followed by ReLU), then the patch projection, a
    16x16/16 conv with a bias, flattened to (B, L, D) tokens;
  * `MultiHeadAttention`: flax's `nn.MultiHeadDotProductAttention`
    (self-attention, `(y, y)`) written out: `query`, `key` and `value`
    are `DenseGeneral`s to (heads, head_dim) with biases, the query is
    divided by sqrt(head_dim) in the model's dtype, the softmax runs in
    that dtype, attention dropout draws one (q_len, kv_len) mask broadcast
    over batch and heads, and `out` is a `DenseGeneral` from (heads,
    head_dim) back to the width. The projections are `HeadDense`, not
    `nn.Linear`, so the int8 route leaves them in float, as the JAX
    package's interceptor does (it takes `nn.Dense` and `nn.Conv` only);
  * `TransformerBlock`: pre-norm attention and MLP (fc1 -> tanh gelu ->
    dropout -> fc2 -> dropout), residual adds;
  * `ViT`: the cls token, a learned position table of length L + 1, the
    SIE table (n_views, 1, D) (created whenever `side_info` and n_views =
    max(num_cams, 1) * max(num_seqs, 1) > 1, added x1.5 only when `cam`
    is given; a view index past the table is clamped, as JAX's gather
    clamps it), dropout, the blocks, a LayerNorm ("to_latent"), cls (or
    mean) pooling, a BNNeck without bias ("bottleneck") and the bias-free
    head ("mlp_head"). Returns (feature, logits) with train=True and
    (bnneck feature, logits) otherwise.

The position table's length is fixed by the input size, so the model is
built for one `input_hw` (the JAX package sizes it at init from the
dummy input). Dropout in train mode draws its masks from the `rng`
generator passed to the forward; at rate 0 none is needed.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, Conv2d, InstanceNorm, LayerNorm, Linear,
                     dropout, gelu, in_dtype, pad_same)

_TRUNC = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> torch.Tensor:
    """flax `truncated_normal(stddev)`: a normal truncated at two
    standard deviations and rescaled to keep `std`."""
    s = std / _TRUNC
    return nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s,
                                 generator=generator)


class MixedNorm(nn.Module):
    """Half instance / half batch norm over NHWC channels."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.half = c // 2
        self.add_module("in", InstanceNorm(self.half, dtype=dtype))
        self.bn = BatchNorm(c - self.half, dtype=dtype)

    def forward(self, x, train: bool = False):
        return torch.cat([getattr(self, "in")(x[..., :self.half]),
                          self.bn(x[..., self.half:], train)], dim=-1)


class ConvStem(nn.Module):
    """The convolution stem: (B, H, W, 3) -> (B, L, D) tokens."""

    def __init__(self, hidden_dim: int = 64, embed_dim: int = 384,
                 stem_stride: int = 2, patch_size: int = 32,
                 dtype=torch.float32):
        super().__init__()
        c = hidden_dim
        self.conv1 = Conv2d(3, c, 7, stride=stem_stride, padding=3,
                            dtype=dtype, f32_sum=True)
        self.mn1 = MixedNorm(c, dtype)
        self.conv2 = Conv2d(c, c, 3, padding=1, dtype=dtype, f32_sum=True)
        self.mn2 = MixedNorm(c, dtype)
        self.conv3 = Conv2d(c, c, 3, padding=1, dtype=dtype, keep_f32=True)
        self.bn3 = BatchNorm(c, dtype=dtype)
        self.p = patch_size // stem_stride
        self.proj = Conv2d(c, embed_dim, self.p, stride=self.p, dtype=dtype,
                           bias=True, f32_sum=True)

    def forward(self, x, train: bool = False):
        x = torch.relu(self.mn1(self.conv1(x), train))
        x = torch.relu(self.mn2(self.conv2(x), train))
        x = torch.relu(self.bn3(self.conv3(x), train))
        x = self.proj(pad_same(x, self.p, self.p))
        b, h, w, d = x.shape
        return x.reshape(b, h * w, d)


class HeadDense(nn.Module):
    """flax `nn.DenseGeneral` between a width and (heads, head_dim), with a
    bias. `to_heads`: (..., width) -> (..., heads, head_dim), flax kernel
    (width, heads, head_dim) and bias (heads, head_dim); otherwise (...,
    heads, head_dim) -> (..., width), flax kernel (heads, head_dim, width)
    and bias (width,). The weight is kept in `nn.Linear`'s (out, in)
    layout over the flattened (heads * head_dim) axis
    (`utils/flax_bridge.py` maps it); the product and the bias add round
    to `dtype` as flax's do."""

    def __init__(self, width: int, heads: int, head_dim: int,
                 to_heads: bool, dtype=torch.float32):
        super().__init__()
        self.heads, self.head_dim, self.to_heads = heads, head_dim, to_heads
        self.dtype = dtype
        inner = heads * head_dim
        cin, cout = (width, inner) if to_heads else (inner, width)
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator):
        # flax's default lecun_normal over the flattened fan-in
        std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if not self.to_heads:
            x = x.flatten(-2)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        y = y + self.bias.to(self.dtype)
        if self.to_heads:
            y = y.unflatten(-1, (self.heads, self.head_dim))
        return y


class MultiHeadAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads, qkv_features=dim,
    dropout_rate)` on (B, L, D) self-attention."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        hd = dim // heads
        self.dtype, self.rate = dtype, dropout
        self.query = HeadDense(dim, heads, hd, True, dtype)
        self.key = HeadDense(dim, heads, hd, True, dtype)
        self.value = HeadDense(dim, heads, hd, True, dtype)
        self.out = HeadDense(dim, heads, hd, False, dtype)
        # query / jnp.sqrt(depth).astype(dtype): XLA multiplies by the f32
        # reciprocal of the root rounded to dtype
        self.inv_root = float(np.float32(1.0) / np.float32(
            in_dtype(math.sqrt(hd), dtype)))

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        dt = self.dtype
        q = self.query(x) * self.inv_root
        k, v = self.key(x), self.value(x)
        w = softmax_in_dtype(torch.einsum("bqhd,bkhd->bhqk", q, k))
        if train and self.rate > 0.0:
            if rng is None:
                raise ValueError("attention dropout in train mode needs a "
                                 "torch.Generator")
            keep = 1.0 - self.rate
            mask = torch.rand((1, 1) + w.shape[-2:], generator=rng,
                              device=w.device) < keep
            # keep.astype(dtype) / asarray(keep_prob, dtype)
            w = w * (mask.to(dt) / torch.full((), keep, dtype=dt,
                                              device=w.device))
        y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(y)


def softmax_in_dtype(logits: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` over the last axis of a `dtype` tensor, as the
    compiled JAX program computes it in bf16: the shift by the max rounds
    to the dtype, exp and its sum run in f32, and the quotient of the
    two, each rounded to the dtype, rounds again. In f32 it is the plain
    softmax."""
    dt = logits.dtype
    d = logits - torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(d.to(torch.float32))
    return e.to(dt) / e.sum(-1, keepdim=True).to(dt)


class TransformerBlock(nn.Module):
    """Pre-norm attention + MLP block."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.rate = dropout
        self.ln1 = LayerNorm(dim, dtype=dtype)
        self.attn = MultiHeadAttention(dim, heads, dropout, dtype)
        self.ln2 = LayerNorm(dim, dtype=dtype)
        self.fc1 = Linear(dim, mlp_dim, dtype, bias=True)
        self.fc2 = Linear(mlp_dim, dim, dtype, bias=True)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        rate = self.rate if train else 0.0
        dt = self.ln1.dtype
        # the norms read the residual sums unrounded (f32), the residual
        # stream takes them rounded to dt; so does the next block with the
        # f32 sum this block returns
        s = residual_sum(x.to(dt), self.attn(self.ln1(x), train, rng))
        y = dropout(gelu(self.fc1(self.ln2(s))), rate, rng)
        return residual_sum(s.to(dt), dropout(self.fc2(y), rate, rng))


def residual_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y in f32, for a LayerNorm to read before the sum is rounded to
    x's dtype: the compiled JAX program fuses the add into the norm's
    statistics and skips that rounding; the residual stream itself keeps
    the rounded sum (`s.to(x.dtype)`)."""
    return x.to(torch.float32) + y.to(torch.float32)


def view_index(cam: torch.Tensor, n: int) -> torch.Tensor:
    """`table[cam]` as JAX's gather reads it: a negative index counts from
    the end, and an index past the table is clamped to its last row."""
    cam = torch.where(cam < 0, cam + n, cam)
    return torch.clamp(cam, 0, n - 1)


class ViT(nn.Module):
    """ViT-t with SIE and a BNNeck head (flax `ViT`)."""

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 num_seqs: int = 0, dim: int = 384, depth: int = 6,
                 heads: int = 16, mlp_dim: int = 2048, dropout: float = 0.1,
                 sie_factor: float = 1.5, side_info: bool = True,
                 pool: str = "cls", input_hw: Tuple[int, int] = (448, 224),
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.rate = dtype, dropout
        self.sie_factor, self.pool = sie_factor, pool
        self.depth = depth
        self.stem = ConvStem(embed_dim=dim, dtype=dtype)
        p = self.stem.p * 2
        n = -(-input_hw[0] // p) * -(-input_hw[1] // p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n + 1, dim))
        self.n_views = max(num_cams, 1) * max(num_seqs, 1)
        self.side_info_embedding = nn.Parameter(
            torch.zeros(self.n_views, 1, dim)) \
            if side_info and self.n_views > 1 else None
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, heads, mlp_dim, dropout, dtype))
        self.to_latent = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.bottleneck = BatchNorm(dim, use_bias=False, dtype=dtype)
        self.mlp_head = Linear(dim, num_classes, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initializers, drawn from `generator`: kaiming for the
        stem's convs, lecun for the projection and the attention,
        truncated normal(0.02) for the tokens, tables and MLP kernels,
        normal(0.001) for the head; biases 0."""
        stem = self.stem
        for conv in (stem.conv1, stem.conv2, stem.conv3):
            conv.reset_parameters(generator)
        stem.proj.reset_parameters(generator, init="lecun")
        for t in (self.cls_token, self.pos_embedding,
                  self.side_info_embedding):
            if t is not None:
                trunc_normal_(t, generator)
        for m in self.modules():
            if isinstance(m, HeadDense):
                m.reset_parameters(generator)
            elif isinstance(m, Linear) and m is not self.mlp_head:
                trunc_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
        self.mlp_head.reset_parameters(generator, std=0.001)
        return self

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False, rng: Optional[torch.Generator] = None):
        dt = self.dtype
        tokens = self.stem(x.to(dt), train)
        b, n, d = tokens.shape
        if n + 1 != self.pos_embedding.shape[1]:
            raise ValueError(f"{n} tokens, but the position table was built "
                             f"for {self.pos_embedding.shape[1] - 1} "
                             "(build the model for this input_hw)")
        cls = self.cls_token.to(dt).expand(b, 1, d)
        tokens = torch.cat([cls, tokens], dim=1)
        adds = [self.pos_embedding.to(dt)]
        if self.side_info_embedding is not None and cam is not None:
            sie = self.side_info_embedding.to(dt)[view_index(cam,
                                                             self.n_views)]
            adds.append(self.sie_factor * sie)
        for a in adds[:-1]:
            tokens = tokens + a
        # the first block's norm reads the last sum unrounded; each block
        # returns its output so (`TransformerBlock`)
        tokens = residual_sum(tokens, adds[-1])
        if train and self.rate > 0.0:
            tokens = dropout(tokens.to(dt), self.rate, rng)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens, train, rng)
        tokens = self.to_latent(tokens)
        feat = tokens.to(torch.float32).mean(1).to(dt) \
            if self.pool == "mean" else tokens[:, 0]
        bn = self.bottleneck(feat, train)
        logits = self.mlp_head(bn)
        return (feat if train else bn), logits
