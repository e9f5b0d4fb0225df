"""The GAN backbones in PyTorch, NHWC: counterpart of `reid_tpu/gan/models.py`.

  * `SelfAttention`: SAGAN attention, its softmax in f32, gamma at 0;
  * `CategoricalConditionalBN`: class-embedded scale and shift over an
    affine-less BatchNorm;
  * `Generator`: the SNGAN-style residual upsampling stack (`GenBlock`s,
    optional self-attention and conditional BN), or with `spectral=False`
    the plain DCGAN ConvTranspose stack; tanh images of 128x64;
  * `Discriminator`: spectrally normalized residual downsampling blocks
    (`DiscBlock`), or the plain DCGAN stack, with three heads: sigmoid,
    Wasserstein (the raw score) and VAE's (score, trunk features);
  * `VAE`: conv encoder -> (mean, var) -> z = mean + var * eps (var, not
    std, as the reference) -> the deconv `VAEDecoder`.

Module names equal the flax ones, so a flax path ("block1/conv1/kernel")
names the same parameter here ("block1.conv1.weight") and the variables
cross through `utils/flax_bridge.py`. Everything computes in f32. Every
module takes `train` (flax's train=True; False by default here, as in the
port's other models): BatchNorm then normalizes with the batch's
statistics and folds them into its running ones, and each spectral norm
stores the `u` and `sigma` of its power-iteration step.

**Spectral norm** is flax's `nn.SpectralNorm`, not
`torch.nn.utils.spectral_norm`: the kernel in flax's layout (kh, kw, in,
out) is read as a (kh * kw * in, out) matrix W; on every call, in eval
mode too, one power-iteration step from the stored u (1, out), v =
l2n(u W^T), u = l2n(v W) with l2n(x) = x * rsqrt(sum(x^2) + 1e-12), both
without a gradient, and sigma = v W u^T (with one) divides the kernel;
the bias is left as it is. `u` and `sigma` are buffers, written back only
in train mode; flax keeps them in `batch_stats` under
"<block>/SpectralNorm_<i>/<layer>/kernel/{u,sigma}".
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import (_TRUNC_STD, BatchNorm, Conv2d, ConvTranspose2d,
                             Linear)

_SN_EPS = 1e-12


def xavier_(w: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator]):
    """flax's xavier_uniform: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(w, -a, a, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]):
    """flax's lecun_normal: a normal truncated at two standard deviations,
    rescaled to variance 1 / fan_in; drawn as normals with the ones past
    2 redrawn (`nn.init.trunc_normal_`'s inverse-erf route takes seconds
    for the VAE's 67M-element dense kernel on a host core)."""
    flat = w.view(-1)
    flat.normal_(generator=generator)
    idx = (flat.abs() > 2).nonzero().squeeze(1)
    while idx.numel():
        s = torch.randn(idx.numel(), generator=generator, device=w.device)
        ok = s.abs() <= 2
        flat[idx[ok]] = s[ok]
        idx = idx[~ok]
    return w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _uninitialized(factory):
    """A layer built without its constructor's init (on the meta device,
    then allocated): the VAE's two 67M-element dense layers, which
    `init_weights` or loaded variables fill."""
    with torch.device("meta"):
        layer = factory()
    return layer.to_empty(device="cpu")


def _reset(m: nn.Module, generator, xavier: bool = False):
    """A conv's or dense layer's init as flax's: lecun normal (or xavier
    uniform) kernel, zero bias."""
    w = m.weight
    if isinstance(m, ConvTranspose2d):      # (in, out, kh, kw)
        fan_in, fan_out = w.shape[0] * w[0, 0].numel(), \
            w.shape[1] * w[0, 0].numel()
    else:                                   # (out, in[, kh, kw])
        fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
    if xavier:
        xavier_(w.data, fan_in, fan_out, generator)
    else:
        lecun_normal_(w.data, fan_in, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias.data)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.avg_pool(x, (2, 2), strides=(2, 2))` on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """flax's `_l2_normalize`: x * rsqrt(sum(x^2) + eps), over all of x."""
    return x * torch.rsqrt((x * x).sum() + _SN_EPS)


class SpectralConv2d(Conv2d):
    """flax `nn.SpectralNorm(nn.Conv(...))` with its bias (one power
    iteration a call; the module docstring says how). `sn_index` is the
    wrapper's number in its block (flax's "SpectralNorm_<i>")."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int,
                 sn_index: int):
        super().__init__(cin, cout, kernel, padding=padding, bias=True)
        self.sn_index = sn_index
        self.register_buffer("u", torch.zeros(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         init: str = "kaiming"):
        super().reset_parameters(generator, init)
        if hasattr(self, "u"):
            nn.init.normal_(self.u, generator=generator)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            v = l2_normalize(self.u @ mat.T)
            u = l2_normalize(v @ mat)
        sigma = (v @ mat @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x, train: bool = False):
        w = self.normalized_weight(train)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32), w,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1) + self.bias


class Embed(nn.Module):
    """flax `nn.Embed`: rows of an (n, features) table."""

    def __init__(self, n: int, features: int, fill: float):
        super().__init__()
        self.embedding = nn.Parameter(torch.full((n, features), fill))

    def forward(self, y):
        return self.embedding[y]


class SelfAttention(nn.Module):
    """SAGAN self-attention (ref discriminator_gan.py:28-60): 1x1 query /
    key (C / 8) and value (C) convs with biases, the softmax of the
    (HW x HW) logits in f32, gamma * out + x with gamma starting at 0."""

    def __init__(self, c: int):
        super().__init__()
        self.query = Conv2d(c, c // 8, 1, bias=True)
        self.key = Conv2d(c, c // 8, 1, bias=True)
        self.value = Conv2d(c, c, 1, bias=True)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        n, h, w, c = x.shape
        q = self.query(x).reshape(n, h * w, -1)
        k = self.key(x).reshape(n, h * w, -1)
        att = torch.softmax(torch.bmm(q, k.transpose(1, 2)).to(torch.float32),
                            dim=-1)
        out = torch.bmm(att, self.value(x).reshape(n, h * w, c))
        return self.gamma * out.reshape(n, h, w, c) + x


class CategoricalConditionalBN(nn.Module):
    """Class-embedded scale and shift over an affine-less BatchNorm
    (momentum 0.9; ref categorical_conditional_bn.py:41-60): gamma starts
    at ones, beta at zeros."""

    def __init__(self, num_classes: int, features: int):
        super().__init__()
        self.bn = BatchNorm(features, use_bias=False, use_scale=False)
        self.gamma = Embed(num_classes, features, 1.0)
        self.beta = Embed(num_classes, features, 0.0)

    def forward(self, x, y, train: bool = False):
        h = self.bn(x, train)
        return h * self.gamma(y)[:, None, None, :] + \
            self.beta(y)[:, None, None, :]


class GenBlock(nn.Module):
    """Residual upsampling block (ref generator_gan.py:9-53): BN ->
    leaky ReLU -> 4x4/2 deconv -> 3x3 conv -> BN -> leaky ReLU -> 3x3
    conv, plus the skip: the input through the same deconv (one kernel
    for both) and a 1x1 conv. With `num_classes` the norms are
    `CategoricalConditionalBN`s and the call needs the labels."""

    def __init__(self, in_ch: int, out_ch: int, num_classes: int = 0,
                 upsample: bool = True):
        super().__init__()
        self.num_classes, self.upsample = num_classes, upsample

        def norm(c):
            return (CategoricalConditionalBN(num_classes, c) if num_classes
                    else BatchNorm(c))
        self.bn1 = norm(in_ch)
        if upsample:
            self.deconv = ConvTranspose2d(in_ch, in_ch, 4, 2, bias=False)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, bias=True)
        self.bn2 = norm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, bias=True)
        self.skip = Conv2d(in_ch, out_ch, 1, bias=True)

    def _norm(self, bn, x, y, train):
        if self.num_classes:
            if y is None:
                raise ValueError("a conditional GenBlock needs labels y")
            return bn(x, y, train)
        return bn(x, train)

    def forward(self, x, y=None, train: bool = False):
        branch = x
        x = F.leaky_relu(self._norm(self.bn1, x, y, train), 0.2)
        if self.upsample:
            x = self.deconv(x)
            branch = self.deconv(branch)
        x = self._norm(self.bn2, self.conv1(x), y, train)
        x = self.conv2(F.leaky_relu(x, 0.2))
        return x + self.skip(branch)


class Generator(nn.Module):
    """nz -> (128, 64, nc) tanh images.

    spectral (SNGAN residual, ref :136-158): a dense layer to (4, 2, ngf),
    four GenBlocks (x2 each; ngf -> ngf -> 8 ngf -> 4 ngf -> 2 ngf) with
    self-attention after the third and fourth under `self_attn`, a 4x4/2
    deconv to nc. plain (DCGAN, ref :159-181): a (4, 2)/(4, 2) VALID
    deconv from 1x1, then four 4x4/2 deconvs, each with BatchNorm
    (flax's default momentum 0.99) and ReLU, and a last one to nc."""

    def __init__(self, nz: int = 100, ngf: int = 64, nc: int = 3,
                 spectral: bool = True, self_attn: bool = False,
                 num_classes: int = 0):
        super().__init__()
        self.nz, self.ngf, self.spectral = nz, ngf, spectral
        self.self_attn = self_attn
        if spectral:
            self.fc = Linear(nz, 4 * 2 * ngf, bias=True)
            widths = (ngf, ngf, ngf * 8, ngf * 4, ngf * 2)
            for i in range(4):
                self.add_module(f"block{i + 1}", GenBlock(
                    widths[i], widths[i + 1], num_classes))
            if self_attn:
                self.attn1 = SelfAttention(ngf * 4)
                self.attn2 = SelfAttention(ngf * 2)
            self.to_rgb = ConvTranspose2d(ngf * 2, nc, 4, 2)
            return
        self.deconv0 = ConvTranspose2d(nz, ngf * 8, (4, 2), (4, 2),
                                       padding="VALID", bias=False)
        self.bn0 = BatchNorm(ngf * 8, momentum=0.99)
        widths = (ngf * 8, ngf * 8, ngf * 4, ngf * 2, ngf)
        for i in range(4):
            self.add_module(f"deconv{i + 1}", ConvTranspose2d(
                widths[i], widths[i + 1], 4, 2, bias=False))
            self.add_module(f"bn{i + 1}", BatchNorm(widths[i + 1],
                                                    momentum=0.99))
        self.to_rgb = ConvTranspose2d(ngf, nc, 4, 2, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's initializers, drawn from `generator`:
        xavier uniform for the GenBlocks' 3x3 and skip convs, lecun normal
        for the rest, zero biases, gamma 0."""
        for name, m in self.named_modules():
            if isinstance(m, (Conv2d, Linear, ConvTranspose2d)):
                _reset(m, generator, xavier=name.rsplit(".", 1)[-1] in (
                    "conv1", "conv2", "skip"))
        return self

    def forward(self, z, y=None, train: bool = False):
        z = z.reshape(z.shape[0], -1).to(torch.float32)
        if self.spectral:
            x = self.fc(z).reshape(-1, 4, 2, self.ngf)
            x = self.block1(x, y, train)
            x = self.block2(x, y, train)
            x = self.block3(x, y, train)
            if self.self_attn:
                x = self.attn1(x)
            x = self.block4(x, y, train)
            if self.self_attn:
                x = self.attn2(x)
            return torch.tanh(self.to_rgb(x))
        x = torch.relu(self.bn0(self.deconv0(z.reshape(-1, 1, 1, self.nz)),
                                train))
        for i in range(1, 5):
            x = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"deconv{i}")(x), train))
        return torch.tanh(self.to_rgb(x))


class DiscBlock(nn.Module):
    """Spectrally normalized residual downsampling block (ref
    discriminator_gan.py:7-25): 3x3 conv (in -> in) -> leaky ReLU 0.1 ->
    3x3 conv -> 2x2 average pool, plus the pooled input through a 1x1
    conv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = SpectralConv2d(in_ch, in_ch, 3, 1, 0)
        self.conv2 = SpectralConv2d(in_ch, out_ch, 3, 1, 1)
        self.skip = SpectralConv2d(in_ch, out_ch, 1, 0, 2)

    def forward(self, x, train: bool = False):
        y = F.leaky_relu(self.conv1(x, train), 0.1)
        y = avg_pool2(self.conv2(y, train))
        return y + self.skip(avg_pool2(x), train)


class Discriminator(nn.Module):
    """Ref discriminator_gan.py:63-154. The trunk: four DiscBlocks (ndf,
    2, 4, 8 ndf; self-attention before the fourth under `self_attn`)
    where `spectral` and not `wasserstein`, else the plain DCGAN stack
    (a 4x4 conv at strides (4, 2), then three 4x4/2 convs, bias-free,
    each but the first followed by BatchNorm at flax's default momentum
    0.99 unless `wasserstein`, leaky ReLU 0.2 throughout). Global average
    pooling gives the features; heads: `vae` -> (score, features) through
    dense 512 -> BatchNorm -> leaky ReLU -> dense 1 (sigmoid unless
    `wasserstein`); else a bias-free dense score, sigmoid unless
    `wasserstein`."""

    def __init__(self, ndf: int = 64, nc: int = 3, vae: bool = False,
                 wasserstein: bool = False, spectral: bool = True,
                 self_attn: bool = False):
        super().__init__()
        self.vae, self.wasserstein = vae, wasserstein
        self.blocks = spectral and not wasserstein
        self.self_attn = self_attn and self.blocks
        if self.blocks:
            widths = (nc, ndf, ndf * 2, ndf * 4, ndf * 8)
            for i in range(4):
                self.add_module(f"block{i + 1}",
                                DiscBlock(widths[i], widths[i + 1]))
            if self.self_attn:
                self.attn = SelfAttention(ndf * 4)
        else:
            self.conv0 = Conv2d(nc, ndf, 4, stride=(4, 2), padding=1)
            for i, d in enumerate((2, 4, 8)):
                self.add_module(f"conv{i + 1}", Conv2d(
                    ndf * d // 2, ndf * d, 4, stride=2, padding=1))
                if not wasserstein:
                    self.add_module(f"bn{i + 1}",
                                    BatchNorm(ndf * d, momentum=0.99))
        feat = ndf * 8
        if vae:
            self.ext_fc1 = Linear(feat, 512, bias=True)
            self.ext_bn = BatchNorm(512)
            self.ext_fc2 = Linear(512, 1, bias=True)
        else:
            self.get_dis = Linear(feat, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initializers from `generator`: xavier uniform for the
        DiscBlocks' convs (and their spectral u from a normal), lecun
        normal for the rest, zero biases."""
        for m in self.modules():
            if isinstance(m, SpectralConv2d):
                _reset(m, generator, xavier=True)
                nn.init.normal_(m.u, generator=generator)
            elif isinstance(m, (Conv2d, Linear)):
                _reset(m, generator)
        return self

    def forward(self, x, train: bool = False):
        x = x.to(torch.float32)
        if self.blocks:
            x = self.block1(x, train)
            x = self.block2(x, train)
            x = self.block3(x, train)
            if self.self_attn:
                x = self.attn(x)
            x = self.block4(x, train)
        else:
            x = F.leaky_relu(self.conv0(x), 0.2)
            for i in range(1, 4):
                x = getattr(self, f"conv{i}")(x)
                if not self.wasserstein:
                    x = getattr(self, f"bn{i}")(x, train)
                x = F.leaky_relu(x, 0.2)
        feats = x.mean(dim=(1, 2))
        if self.vae:
            h = F.leaky_relu(self.ext_bn(self.ext_fc1(feats), train), 0.2)
            score = self.ext_fc2(h)
            if not self.wasserstein:
                score = torch.sigmoid(score)
            return score, feats
        score = self.get_dis(feats)
        return score if self.wasserstein else torch.sigmoid(score)


class VAEDecoder(nn.Module):
    """Deconv decoder (ref generator_gan.py:96-125): dense to 16x8x256 ->
    BatchNorm -> leaky ReLU 0.2, three 6x6/2 SAME deconvs (256, 128, 32)
    each followed by BatchNorm, a 5x5 conv to RGB, tanh."""

    def __init__(self, zdim: int = 128):
        super().__init__()
        self.dec_fc = _uninitialized(lambda: Linear(zdim, 16 * 8 * 256,
                                                    bias=True))
        self.dec_fc_bn = BatchNorm(16 * 8 * 256)
        cin = 256
        for i, d in enumerate((256, 128, 32)):
            self.add_module(f"dec_deconv{i}",
                            ConvTranspose2d(cin, d, 6, 2, bias=False))
            self.add_module(f"dec_bn{i}", BatchNorm(d))
            cin = d
        self.dec_rgb = Conv2d(32, 3, 5, padding=2, bias=True)

    def forward(self, z, train: bool = False):
        h = F.leaky_relu(self.dec_fc_bn(self.dec_fc(z), train), 0.2)
        h = h.reshape(-1, 16, 8, 256)
        for i in range(3):
            h = getattr(self, f"dec_bn{i}")(
                getattr(self, f"dec_deconv{i}")(h), train)
        return torch.tanh(self.dec_rgb(h))


class VAE(nn.Module):
    """Conv VAE (ref generator_gan.py:57-133) on (128, 64, 3) images in
    [-1, 1]: three 5x5/2 bias-free convs (64, 128, 256) with BatchNorm
    (ReLU, ReLU, leaky ReLU 0.2), dense 2,048 -> BatchNorm -> ReLU, the
    dense mean and var heads, z = mean + var * eps and the decoder.
    `forward(x, eps, train)` returns (mean, var, reconstruction); eps
    (N, zdim) is the caller's normal draw (JAX's `rng` argument);
    `decode(z)` samples images. The dense layers enc_fc (32,768 x 2,048)
    and dec_fc hold no values until `init_weights` or loaded variables
    fill them."""

    def __init__(self, zdim: int = 128):
        super().__init__()
        self.zdim = zdim
        self.decoder = VAEDecoder(zdim)
        cin = 3
        for i, d in enumerate((64, 128, 256)):
            self.add_module(f"enc_conv{i}",
                            Conv2d(cin, d, 5, stride=2, padding=2))
            self.add_module(f"enc_bn{i}", BatchNorm(d))
            cin = d
        self.enc_fc = _uninitialized(lambda: Linear(16 * 8 * 256, 2048,
                                                    bias=True))
        self.enc_fc_bn = BatchNorm(2048)
        self.fc_mean = Linear(2048, zdim, bias=True)
        self.fc_var = Linear(2048, zdim, bias=True)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's default initializers (lecun normal, zero biases) from
        `generator`."""
        for m in self.modules():
            if isinstance(m, (Conv2d, Linear, ConvTranspose2d)):
                _reset(m, generator)
        return self

    def decode(self, z, train: bool = False):
        return self.decoder(z, train)

    def forward(self, x, eps, train: bool = False):
        x = x.to(torch.float32)
        for i in range(3):
            x = getattr(self, f"enc_bn{i}")(getattr(self, f"enc_conv{i}")(x),
                                            train)
            x = torch.relu(x) if i < 2 else F.leaky_relu(x, 0.2)
        x = torch.relu(self.enc_fc_bn(self.enc_fc(x.reshape(x.shape[0], -1)),
                                      train))
        mean, var = self.fc_mean(x), self.fc_var(x)
        z = mean + var * eps                 # ref :129-131 (var, not std)
        return mean, var, self.decoder(z, train)
