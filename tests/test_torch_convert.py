"""Numerical parity: torch ResNet18-IBN-a trunk vs SERes18IBN(attention=none)
with converted weights — validates both the converter and the trunk
semantics (stem without ReLU is the reference's executed graph, so the torch
side mirrors that too)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
import torch.nn as tnn  # noqa: E402

from reid_tpu.models.seres18 import SERes18IBN  # noqa: E402
from reid_tpu.utils.torch_convert import convert_resnet18_ibn  # noqa: E402
from test_torch_train_data import two_torch_threads  # noqa: E402,F401


class TorchIBN(tnn.Module):
    """IBN-a split norm (torch mirror of ref SERes18_IBN.py:67-93)."""

    def __init__(self, planes):
        super().__init__()
        half = planes // 2
        self.IN = tnn.InstanceNorm2d(half, affine=True)
        self.BN = tnn.BatchNorm2d(planes - half)

    def forward(self, x):
        half = x.shape[1] // 2
        return torch.cat([self.IN(x[:, :half].contiguous()),
                          self.BN(x[:, half:].contiguous())], 1)


class TorchBasicBlock(tnn.Module):
    """torchvision-style BasicBlock (no torchvision in this image)."""

    def __init__(self, inplanes, planes, stride=1, ibn=False,
                 downsample=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = TorchIBN(planes) if ibn else tnn.BatchNorm2d(planes)
        self.relu = tnn.ReLU()
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = None
        if downsample:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(inplanes, planes, 1, stride, bias=False),
                tnn.BatchNorm2d(planes))

    def forward(self, x):
        identity = x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(y + identity)


class TorchResNet18IBN(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        self.layer1 = tnn.Sequential(
            TorchBasicBlock(64, 64, ibn=True),
            TorchBasicBlock(64, 64, ibn=True))
        self.layer2 = tnn.Sequential(
            TorchBasicBlock(64, 128, 2, ibn=True, downsample=True),
            TorchBasicBlock(128, 128, ibn=True))
        self.layer3 = tnn.Sequential(
            TorchBasicBlock(128, 256, 2, ibn=True, downsample=True),
            TorchBasicBlock(256, 256, ibn=True))
        # stage-4 stride 1 (ref :223)
        self.layer4 = tnn.Sequential(
            TorchBasicBlock(256, 512, 1, ibn=False, downsample=True),
            TorchBasicBlock(512, 512, ibn=False))


def _make_torch_ibn_resnet18():
    return TorchResNet18IBN()


def _torch_trunk_forward(m, x):
    """Reference's executed stem (NO relu after bn0, ref :253) + blocks."""
    x = m.conv1(x)
    x = m.bn1(x)
    x = m.maxpool(x)
    for layer in (m.layer1, m.layer2, m.layer3, m.layer4):
        x = layer(x)
    return x


def test_trunk_parity_torch_vs_flax(rng):
    tm = _make_torch_ibn_resnet18().eval()
    # randomize BN running stats so the test is not trivially 0/1
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.8, 1.2)

    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    fm = SERes18IBN(num_classes=5, attention="none")
    x = rng.normal(size=(2, 80, 40, 3)).astype(np.float32)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": jax.device_get(variables["batch_stats"])}
    converted = convert_resnet18_ibn(sd, variables)

    with torch.no_grad():
        want = _torch_trunk_forward(
            tm, torch.tensor(np.transpose(x, (0, 3, 1, 2))))
    want = np.transpose(want.numpy(), (0, 2, 3, 1))       # NCHW -> NHWC

    # flax trunk output = feature map before pooling; grab it by running the
    # model and inverting the GeM pool? Instead compare pooled avg features:
    # run full flax, but the trunk output is what feeds GeM — use avg pooling
    # on both sides for the comparison.
    feat_flax, _ = fm.apply(converted, jnp.asarray(x), train=False)
    # torch side: GeM with the *initialized* p is applied in flax; emulate by
    # comparing spatial means instead: recompute flax trunk via intermediates
    _, intermediates = fm.apply(
        converted, jnp.asarray(x), train=False,
        capture_intermediates=lambda mdl, name: name == "__call__",
    )
    # simplest robust check: block42 output == torch trunk output
    inter = intermediates["intermediates"]
    flax_trunk = np.asarray(inter["block42"]["__call__"][0])
    np.testing.assert_allclose(flax_trunk, want, rtol=2e-2, atol=2e-2)
    # and the discrepancy is small in relative terms
    rel = np.abs(flax_trunk - want).mean() / (np.abs(want).mean() + 1e-9)
    assert rel < 1e-3, rel


# ---------------------------------------------------- FULL-model parity

class TorchGeM(tnn.Module):
    """Ref attention_pooling.py:49-66."""

    def __init__(self, p=3.0, eps=1e-6):
        super().__init__()
        self.p = tnn.Parameter(torch.ones(1) * p)
        self.eps = eps

    def forward(self, x):
        return x.clamp(min=self.eps).pow(self.p).mean(
            (2, 3), keepdim=True).pow(1.0 / self.p)


class TorchSEBlock(tnn.Module):
    """Ref SERes18_IBN.py:13-41 (executed path: no BN, fc1 conv + fc2 linear,
    both bias-free)."""

    def __init__(self, c_in):
        super().__init__()
        mip = max(8, c_in // 16)
        self.fc1 = tnn.Conv2d(c_in, mip, 1, bias=False)
        self.fc2 = tnn.Linear(mip, c_in, bias=False)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.fc1(s).squeeze(-1).squeeze(-1)
        s = torch.relu(s)
        s = self.fc2(s)
        return torch.sigmoid(s)[:, :, None, None]


class TorchSEBasicBlock(tnn.Module):
    """Ref SERes18_IBN.py:96-128 — reference attribute/state-dict naming."""

    def __init__(self, block, dim):
        super().__init__()
        from collections import OrderedDict
        self.block_pre = tnn.Sequential(OrderedDict([
            ("conv1", block.conv1), ("bn1", block.bn1), ("relu", block.relu),
            ("conv2", block.conv2), ("bn2", block.bn2)]))
        self.block_post = None
        if block.downsample is not None:
            self.block_post = tnn.Sequential(OrderedDict([
                ("conv", block.downsample[0]), ("bn", block.downsample[1])]))
        self.seblock = TorchSEBlock(dim)

    def forward(self, x):
        branch = x
        y = self.block_pre(x)
        y = self.seblock(y) * y
        if self.block_post is not None:
            branch = self.block_post(branch)
        return torch.relu(y + branch)


class TorchSERes18Full(tnn.Module):
    """Torch mirror of the FULL ref SERse18_IBN (:186-277): trunk + SE +
    GeM + frozen-bias BNNeck + bias-free classifier + cam_bias."""

    def __init__(self, num_class=5, num_cams=3, cam_factor=1.5):
        super().__init__()
        m = TorchResNet18IBN()
        self.conv0 = m.conv1
        self.bn0 = m.bn1
        self.pooling0 = m.maxpool
        dims = (64, 64, 128, 128, 256, 256, 512, 512)
        blocks = [m.layer1[0], m.layer1[1], m.layer2[0], m.layer2[1],
                  m.layer3[0], m.layer3[1], m.layer4[0], m.layer4[1]]
        for i, (b, d) in enumerate(zip(blocks, dims)):
            setattr(self, f"basicBlock{i // 2 + 1}{i % 2 + 1}",
                    TorchSEBasicBlock(b, d))
        self.avgpooling = TorchGeM(p=2.7)
        self.bnneck = tnn.BatchNorm1d(512)
        with torch.no_grad():
            self.bnneck.bias.zero_()          # frozen at 0 (ref :236-239)
        self.classifier = tnn.Sequential(tnn.Linear(512, num_class,
                                                    bias=False))
        self.cam_bias = tnn.Parameter(torch.randn(num_cams, 512) * 0.02)
        self.cam_factor = cam_factor

    def forward(self, x, cam=None):
        x = self.pooling0(self.bn0(self.conv0(x)))   # no relu (ref :253)
        for s in range(1, 5):
            for b in range(1, 3):
                x = getattr(self, f"basicBlock{s}{b}")(x)
        feature = self.avgpooling(x).flatten(1)
        x_normed = self.bnneck(feature)
        if cam is not None:
            x_normed = x_normed + self.cam_factor * self.cam_bias[cam]
        return x_normed, self.classifier(x_normed)


def test_full_model_parity_torch_vs_flax(rng):
    """END-TO-END parity: eval (bnneck_feat, logits) of the full reference
    model (incl. SE gates, GeM p, BNNeck, cam bias, classifier) vs the flax
    model with a converted reference-format checkpoint."""
    from reid_tpu.utils.torch_convert import convert_seres18_full

    tm = TorchSERes18Full(num_class=5, num_cams=3, cam_factor=1.5).eval()
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, (tnn.BatchNorm2d, tnn.BatchNorm1d)):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.8, 1.2)
        tm.bnneck.bias.zero_()
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    fm = SERes18IBN(num_classes=5, num_cams=3, cam_factor=1.5)
    x = rng.normal(size=(2, 80, 40, 3)).astype(np.float32)
    cams = np.asarray([0, 2])
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": jax.device_get(variables["batch_stats"])}
    converted = convert_seres18_full(sd, variables)

    with torch.no_grad():
        want_feat, want_logits = tm(
            torch.tensor(np.transpose(x, (0, 3, 1, 2))),
            cam=torch.tensor(cams))
    got_feat, got_logits = fm.apply(converted, jnp.asarray(x),
                                    cam=jnp.asarray(cams), train=False)
    for got, want in ((got_feat, want_feat.numpy()),
                      (got_logits, want_logits.numpy())):
        got = np.asarray(got)
        rel = np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9)
        assert rel < 1e-3, rel
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# torchvision plain-ResNet trunks (ft_baseline / ft_net / AGW backbones)
# ---------------------------------------------------------------------------

class _TVBasic(tnn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.relu = tnn.ReLU()
        self.downsample = None
        if downsample:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, planes, 1, stride, bias=False),
                tnn.BatchNorm2d(planes))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + idt)


class _TVBottleneck(tnn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.relu = tnn.ReLU()
        self.downsample = None
        if downsample:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                tnn.BatchNorm2d(planes * 4))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + idt)


class _TVResNet(tnn.Module):
    """torchvision-layout trunk with reid last-stride-1 on layer4."""

    def __init__(self, blocks, bottleneck):
        super().__init__()
        blk = _TVBottleneck if bottleneck else _TVBasic
        exp = 4 if bottleneck else 1
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        cin = 64
        for li, (p, nb) in enumerate(zip((64, 128, 256, 512), blocks), 1):
            mods = []
            for b in range(nb):
                stride = 2 if (li > 1 and b == 0 and li != 4) else 1
                down = b == 0 and (li > 1 or exp > 1)
                mods.append(blk(cin, p, stride, down))
                cin = p * exp
            setattr(self, f"layer{li}", tnn.Sequential(*mods))
        self.blocks = blocks

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3))   # GAP feature


def _randomize_tv(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for m in model.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=g) * 0.5 + .75)


@pytest.mark.parametrize("blocks,bottleneck", [
    ((2, 2, 2, 2), False),   # resnet18 layout (ft_baseline)
    ((1, 1, 1, 1), True),    # bottleneck layout (ft_net/AGW trunk family)
])
def test_convert_torchvision_resnet_trunk_parity(blocks, bottleneck):
    from reid_tpu.models.baseline import ResNetReID
    from reid_tpu.utils.torch_convert import convert_torchvision_resnet

    tm = _TVResNet(blocks, bottleneck).eval()
    _randomize_tv(tm)

    fm = ResNetReID(num_classes=5, block="bottleneck" if bottleneck
                    else "basic", blocks=blocks, pooling="avg",
                    bottleneck_dim=0)
    variables = jax.jit(lambda k, x: fm.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, 40, 3)))
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    variables = convert_torchvision_resnet(sd, variables, blocks=blocks,
                                           bottleneck=bottleneck)

    x = np.random.default_rng(3).normal(size=(2, 80, 40, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)))).numpy()
    # eval mode exercises the CONVERTED running stats; the fresh BNNeck is
    # identity up to eps (mean 0 / var 1 / scale 1, no bias)
    feat, _ = jax.jit(lambda v, xx: fm.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(feat), want, rtol=2e-3, atol=2e-3)
