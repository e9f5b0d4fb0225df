"""OSNet converter parity: torchreid-layout torch OSNet vs reid_tpu OSNet
with converted weights (trunk + feature head, fresh classifier excluded)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
import torch.nn as tnn  # noqa: E402

from reid_tpu.models.osnet import OSNet  # noqa: E402
from reid_tpu.utils.torch_convert import convert_osnet  # noqa: E402
from test_torch_train_data import two_torch_threads  # noqa: E402,F401


class TConvLayer(tnn.Module):
    def __init__(self, cin, cout, k, s=1, p=0, groups=1):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, s, p, bias=False, groups=groups)
        self.bn = tnn.BatchNorm2d(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class TLightConv(tnn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 1, bias=False)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False, groups=cout)
        self.bn = tnn.BatchNorm2d(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv2(self.conv1(x))))


class TGate(tnn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        mid = max(c // reduction, 4)
        self.fc1 = tnn.Conv2d(c, mid, 1)
        self.fc2 = tnn.Conv2d(mid, c, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = torch.relu(self.fc1(s))
        return torch.sigmoid(self.fc2(s)) * x


class TOSBlock(tnn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        mid = cout // 4
        self.conv1 = TConvLayer(cin, mid, 1)
        self.conv2a = TLightConv(mid, mid)
        self.conv2b = tnn.Sequential(TLightConv(mid, mid), TLightConv(mid, mid))
        self.conv2c = tnn.Sequential(*[TLightConv(mid, mid) for _ in range(3)])
        self.conv2d = tnn.Sequential(*[TLightConv(mid, mid) for _ in range(4)])
        self.gate = TGate(mid)
        self.conv3 = TConvLayerNoRelu(mid, cout, 1)
        self.downsample = None
        if cin != cout:
            self.downsample = TConvLayerNoRelu(cin, cout, 1)

    def forward(self, x):
        identity = x
        x1 = self.conv1(x)
        y = (self.gate(self.conv2a(x1)) + self.gate(self.conv2b(x1))
             + self.gate(self.conv2c(x1)) + self.gate(self.conv2d(x1)))
        y = self.conv3(y)
        if self.downsample is not None:
            identity = self.downsample(identity)
        return torch.relu(y + identity)


class TConvLayerNoRelu(tnn.Module):
    def __init__(self, cin, cout, k, s=1, p=0):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, s, p, bias=False)
        self.bn = tnn.BatchNorm2d(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class TOSNet(tnn.Module):
    """torchreid-layout OSNet x1.0 trunk + feature head."""

    def __init__(self, num_classes=5):
        super().__init__()
        c = (64, 256, 384, 512)
        self.conv1 = TConvLayer(3, c[0], 7, 2, 3)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        self.conv2 = tnn.Sequential(TOSBlock(c[0], c[1]), TOSBlock(c[1], c[1]),
                                    TConvLayer(c[1], c[1], 1))
        self.pool2 = tnn.AvgPool2d(2, 2)
        self.conv3 = tnn.Sequential(TOSBlock(c[1], c[2]), TOSBlock(c[2], c[2]),
                                    TConvLayer(c[2], c[2], 1))
        self.pool3 = tnn.AvgPool2d(2, 2)
        self.conv4 = tnn.Sequential(TOSBlock(c[2], c[3]), TOSBlock(c[3], c[3]))
        self.conv5 = TConvLayer(c[3], c[3], 1)
        self.fc = tnn.Sequential(tnn.Linear(c[3], 512), tnn.BatchNorm1d(512),
                                 tnn.ReLU())

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.pool2(self.conv2(x))
        x = self.pool3(self.conv3(x))
        x = self.conv5(self.conv4(x))
        v = x.mean((2, 3))
        return self.fc(v)


def test_osnet_converter_parity(rng):
    tm = TOSNet().eval()
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, (tnn.BatchNorm2d, tnn.BatchNorm1d)):
                mod.running_mean.uniform_(-0.1, 0.1)
                mod.running_var.uniform_(0.9, 1.1)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    fm = OSNet(num_classes=5)
    x = rng.normal(size=(2, 80, 40, 3)).astype(np.float32)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": jax.device_get(variables["batch_stats"])}
    converted = convert_osnet(sd, variables)

    with torch.no_grad():
        want = tm(torch.tensor(np.transpose(x, (0, 3, 1, 2)))).numpy()
    feat, _ = fm.apply(converted, jnp.asarray(x), train=False)
    got = np.asarray(feat)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    rel = np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9)
    assert rel < 1e-3, rel
