"""The 3-D video ResNet (`models/video3d.py`) and its layers in the port
against the JAX package's flax modules, on numpy inputs from a seed;
weights are flax inits with random running statistics and biases
(test_torch_attention.randomize), carried through the bridge.

  * Layers: `InstanceNorm` normalizes a clip over (T, H, W) as flax's
    does over every axis between batch and channel, and its 4-D result
    is the (H, W) reduction it always was; `Conv3d` (f32 within 1e-5 of
    the largest magnitude; bf16 with `f32_sum`, the rounded f32 conv,
    bit-equal), `GeM3D` and `max_pool3d` against flax.
  * bf16 blocks against the jitted flax blocks, eval and train mode
    (train: the new statistics within 1e-5 of theirs): the stem (conv1,
    bn1, ReLU, max pool), `MixedNorm3D`, `Bottleneck3D` with and without
    a downsample, IBN and not, stride 1 and 2, and `GeM3D`. At reduced
    widths (8-16 planes) each is bit-equal. At the model's widths (64-512
    planes, a conv summing up to 6,912 products) XLA:CPU sums the f32
    convs, dots and norm statistics in another order than torch (at 8x4
    pixels it even runs conv2 with the operands swapped, `window=3x4x2
    ... rhs_reversal`, in `compile().as_text()`), and an f32 ulp of a sum
    then lands a bf16 rounding on the other side now and then: at most
    2% of the outputs apart and each within 2^-6 of the block's largest
    magnitude (read: 0-1.2% apart, by one bf16 ulp except where the
    residual sum before the last ReLU cancels, up to 0.0064 of the
    largest magnitude, in the 1,024-channel block at stride 1).
  * `VideoResNet(blocks=(1, 1, 1, 1))`, the model's widths (planes
    64-512, a 2,048-wide feature) on 4 x 2 x 64 x 32 clips: f32 within
    rtol = atol = 1e-4 in eval and train mode, both outputs, and the
    running statistics after the train-mode pass; bf16, both modes, an
    L2 distance from flax's f32 output at most 1.25x flax's own bf16
    program's; in eval mode also within 2^-6 of the largest magnitude
    and a cosine a row of at least 0.99998. In train mode the BatchNorms
    take their statistics over 16-64 values a channel in the deep stages
    and the BNNeck over the batch of 4, and bf16 moves both frameworks
    far from f32 (flax's own bf16 train-mode logits read a cosine of
    0.9901 from its f32 ones, the port's 0.9902): there each row's cosine
    to the f32 output is at most 1e-3 under flax's own, and to flax's
    bf16 output at least 0.998 (read 0.9988).
  * The bridge: the flax trees of `video_resnet50` and `video_resnet18`
    (`jax.eval_shape`, nothing compiled) equal the port's, round-trip
    unchanged, and a 5-D kernel (kT, kH, kW, I, O) maps to (O, I, kT, kH,
    kW) explicitly; 47,193,153 parameters at 512 classes for
    video_resnet50 and 27,530,561 for video_resnet18, as flax counts.
  * The image CLIs: the JAX package's model fails on a 4-D crop batch,
    and the port's three image CLIs refuse the video names at the
    parser.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from reid_tpu.models import build_model as jbuild
from reid_tpu.models import layers as jl
from reid_tpu.models import video3d as jv
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models import layers as tl
from reid_tpu_torch.models import video3d as tv
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              kernel_from_torch,
                                              kernel_to_torch,
                                              load_flax_variables,
                                              torch_state_dict)
from test_torch_attention import close, randomize, tree
from test_torch_cares import cosine_rows
from test_torch_train_data import two_torch_threads  # noqa: F401

BF = jnp.bfloat16
RNG = np.random.default_rng(0)


def test_instance_norm_reduces_inner_axes():
    """5-D: flax's (T, H, W) statistics; 4-D: the (H, W) reduction, the
    same ops as before."""
    c = 12
    jm = jl.InstanceNorm()
    pm = tl.InstanceNorm(c)
    for shape in ((2, 3, 5, 4, c), (2, 5, 4, c)):
        x = RNG.normal(size=shape).astype(np.float32) * 3 + 1
        v = {"params": {"scale": RNG.normal(size=c).astype(np.float32),
                        "bias": RNG.normal(size=c).astype(np.float32)}}
        want = jax.jit(jm.apply)(v, jnp.asarray(x))
        load_flax_variables(pm, v)
        with torch.no_grad():
            got = pm(torch.from_numpy(x))
        close(got.numpy(), np.asarray(want), 1e-5)
    xf = torch.from_numpy(x)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = torch.square(xf - mean).mean(dim=(1, 2), keepdim=True)
    with torch.no_grad():
        old = ((xf - mean) * torch.rsqrt(var + 1e-5)) * pm.weight + pm.bias
        assert torch.equal(pm(xf), old)


class JConv(nn.Module):
    kernel: tuple = (3, 3, 3)
    strides: tuple = (1, 2, 2)
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        return jv.conv3d(16, self.kernel, self.strides, "conv",
                         self.dtype)(x.astype(self.dtype))


@pytest.mark.parametrize("kernel,strides", [((3, 3, 3), (1, 2, 2)),
                                            ((1, 7, 7), (1, 2, 2)),
                                            ((1, 1, 1), (1, 1, 1))])
def test_conv3d_matches_flax(kernel, strides):
    x = RNG.normal(size=(2, 3, 9, 6, 8)).astype(np.float32)
    for dt, tdt in ((jnp.float32, torch.float32), (BF, torch.bfloat16)):
        jm = JConv(kernel, strides, dt)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)), np.float32)
        pm = torch.nn.Module()
        pm.conv = tl.Conv3d(8, 16, kernel, strides, tdt, f32_sum=True)
        load_flax_variables(pm, tree(v))
        with torch.no_grad():
            got = pm.conv(torch.from_numpy(x)).float().numpy()
        assert got.shape == want.shape
        if dt == jnp.float32:
            close(got, want, 1e-5)
        else:
            np.testing.assert_array_equal(got, want)


def test_gem3d_and_max_pool_match_flax():
    x = np.abs(RNG.normal(size=(2, 3, 6, 4, 32))).astype(np.float32)
    jm = jl.GeM3D(dtype=BF)
    v = {"params": {"p": np.float32(2.5)}}
    want = jax.jit(jm.apply)(v, jnp.asarray(x).astype(BF))
    pm = tl.GeM3D(dtype=torch.bfloat16)
    with torch.no_grad():
        pm.p.fill_(2.5)
        got = pm(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    y = RNG.normal(size=(2, 3, 9, 6, 5)).astype(np.float32)
    want = nn.max_pool(jnp.asarray(y), (1, 3, 3), strides=(1, 2, 2),
                       padding=((0, 0), (1, 1), (1, 1)))
    got = tl.max_pool3d(torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class JStem(nn.Module):
    """VideoResNet's stem as flax runs it (video3d.py:107-113)."""
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x, train=True):
        x = jv.conv3d(64, (1, 7, 7), (1, 2, 2), "conv1", self.dtype)(
            x.astype(self.dtype))
        x = nn.relu(nn.BatchNorm(use_running_average=not train, momentum=0.9,
                                 epsilon=1e-5, dtype=self.dtype,
                                 name="bn1")(x))
        return nn.max_pool(x, (1, 3, 3), strides=(1, 2, 2),
                           padding=((0, 0), (1, 1), (1, 1)))


class TStem(torch.nn.Module):
    def __init__(self, dtype):
        super().__init__()
        m = tv.VideoResNet(blocks=(0, 0, 0, 0), dtype=dtype)
        self.conv1, self.bn1 = m.conv1, m.bn1

    def forward(self, x, train=False):
        return tl.max_pool3d(torch.relu(self.bn1(self.conv1(
            x.to(torch.bfloat16)), train)))


class JGeM(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return jl.GeM3D(dtype=BF, name="gem")(x)


class TGeM(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gem = tl.GeM3D(dtype=torch.bfloat16)

    def forward(self, x, train=False):
        return self.gem(x)


def block(kind):
    """(flax block, port block, input shape (N, T, H, W, C)) of a case."""
    if kind == "stem":
        return JStem(dtype=BF), TStem(torch.bfloat16), (2, 3, 64, 32, 3)
    if kind.startswith("mixed"):
        c = int(kind[5:])
        return (jv.MixedNorm3D(dtype=BF), tv.MixedNorm3D(c, torch.bfloat16),
                (2, 3, 8, 4, c))
    if kind == "gem":
        return JGeM(), TGeM(), (2, 3, 4, 2, 2048)
    cin, planes, stride, ibn, down = (int(v) for v in kind.split("-")[1:])
    hw = (8, 6) if planes < 64 else (8, 4)
    return (jv.Bottleneck3D(planes, strides=stride, ibn=bool(ibn),
                            downsample=bool(down), dtype=BF),
            tv.Bottleneck3D(cin, planes, stride, bool(ibn), bool(down),
                            torch.bfloat16), (2, 3, *hw, cin))


# bottleneck-cin-planes-stride-ibn-down; the reduced widths first
REDUCED = ["mixed16", "bottleneck-16-8-1-1-1", "bottleneck-32-8-2-0-1",
           "bottleneck-32-8-2-1-1", "gem"]
FULL = ["stem", "mixed64", "bottleneck-64-64-1-1-1",
        "bottleneck-256-64-1-1-0", "bottleneck-256-128-2-1-1",
        "bottleneck-512-256-2-0-1", "bottleneck-1024-256-1-0-0"]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", REDUCED + FULL)
def test_block_bf16_matches_flax(kind, train):
    jm, pm, shape = block(kind)
    x = np.abs(RNG.normal(size=shape)).astype(np.float32) if kind == "gem" \
        else np.random.default_rng(len(kind)).normal(size=shape).astype(
            np.float32)
    xj = jnp.asarray(x).astype(BF)
    v = randomize(jax.jit(lambda k, xx: jm.init(k, xx, train=True))(
        jax.random.PRNGKey(0), xj), 1)
    if train:
        want, mut = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, train=True, mutable=["batch_stats"]))(v, xj)
    else:
        want = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, xj)
    load_flax_variables(pm, v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(torch.bfloat16), train=train)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if kind in REDUCED:
        np.testing.assert_array_equal(got, want)
    else:
        share = float((got != want).mean())
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert share <= 0.02 and err <= 2.0 ** -6, (share, err)
    if train and "batch_stats" in mut:
        stats = torch_state_dict({"batch_stats": tree(mut["batch_stats"])})
        for name, buf in pm.named_buffers():
            close(buf.numpy(), stats[name].numpy(), 1e-5)


X = np.random.default_rng(1).normal(size=(4, 2, 64, 32, 3)).astype(
    np.float32)


@pytest.fixture(scope="module")
def model_runs():
    """flax VideoResNet(blocks=(1, 1, 1, 1)) of 8 classes from one init,
    in f32 and bf16, eval and train mode: {(dtype, train): (outputs,
    new statistics)} and the variables."""
    out = {}
    v = None
    for dt in ("float32", "bfloat16"):
        jm = jv.VideoResNet(num_classes=8, blocks=(1, 1, 1, 1),
                            dtype=getattr(jnp, dt))
        if v is None:
            v = randomize(jax.jit(lambda k, xx: jm.init(k, xx, train=True))(
                jax.random.PRNGKey(0), jnp.asarray(X)), 1)
        out[(dt, False)] = (tree(jax.jit(lambda vv, xx: jm.apply(
            vv, xx, train=False))(v, jnp.asarray(X))), None)
        y, mut = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, train=True, mutable=["batch_stats"]))(v, jnp.asarray(X))
        out[(dt, True)] = (tree(y), tree(mut["batch_stats"]))
    return out, v


def port_run(v, dtype, train):
    pm = tv.VideoResNet(num_classes=8, blocks=(1, 1, 1, 1),
                        dtype=getattr(torch, dtype))
    load_flax_variables(pm, v)
    with torch.no_grad():
        outs = pm(torch.from_numpy(X), train=train)
    return [o.float().numpy() for o in outs], pm


@pytest.mark.parametrize("train", [False, True])
def test_model_f32_matches_flax(model_runs, train):
    runs, v = model_runs
    (want, stats) = runs[("float32", train)]
    got, pm = port_run(v, "float32", train)
    assert got[0].shape == (4, 2048) and got[1].shape == (4, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    if train:
        sd = torch_state_dict({"batch_stats": stats})
        for name, buf in pm.named_buffers():
            np.testing.assert_allclose(buf.numpy(), sd[name].numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_model_bf16_matches_flax(model_runs, train):
    runs, v = model_runs
    ref = runs[("float32", train)][0]
    want = runs[("bfloat16", train)][0]
    got, _ = port_run(v, "bfloat16", train)
    for g, w, r in zip(got, want, ref):
        w, r = np.asarray(w, np.float32), np.asarray(r, np.float32)
        assert np.linalg.norm(g - r) <= 1.25 * np.linalg.norm(w - r)
        if not train:
            assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
            assert cosine_rows(g, w).min() >= 0.99998
        else:
            own = cosine_rows(w, r).min()
            assert cosine_rows(g, r).min() >= own - 1e-3
            assert cosine_rows(g, w).min() >= 0.998


def flax_shapes(name, classes):
    jm = jbuild(name, num_classes=classes)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 2, 32, 16, 3)),
                                       train=True))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), v)


@pytest.mark.parametrize("name,count", [("video_resnet50", 47_193_153),
                                        ("video_resnet18", 27_530_561)])
def test_bridge_round_trips_the_video_trees(name, count):
    pm = build_model(name, num_classes=512, device="cpu")
    assert isinstance(pm, tv.VideoResNet)
    assert sum(p.numel() for p in pm.parameters()) == count
    v = flax_variables(pm)
    assert jax.tree_util.tree_map(np.shape, v) == flax_shapes(name, 512)
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(
        v["params"])) == count
    # random values, so the round trip shows every leaf in its place
    rng = np.random.default_rng(2)
    v = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), v)
    load_flax_variables(pm, v)
    back = flax_variables(pm)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, v))
    k = v["params"]["layer1_0"]["conv2"]["kernel"]
    assert k.shape == (3, 3, 3, 64, 64)
    w = pm.layer1_0.conv2.weight.detach().numpy()
    assert w.shape == (64, 64, 3, 3, 3)
    assert np.array_equal(w[5, 7, 0, 1, 2], k[0, 1, 2, 7, 5])
    assert np.array_equal(kernel_to_torch(k), w)
    assert np.array_equal(kernel_from_torch(w), k)
    stem = pm.conv1.weight
    assert tuple(stem.shape) == (64, 3, 1, 7, 7)


def test_factory_passes_keyword_arguments():
    pm = build_model("video_resnet18", num_classes=5, device="cpu",
                     pooling="avg", blocks=(1, 1, 1, 1))
    assert pm.gem is None and pm.stages == [
        "layer1_0", "layer2_0", "layer3_0", "layer4_0"]
    assert pm.layer1_0.bn1.half == 32 and not isinstance(
        pm.layer3_0.bn1, tv.MixedNorm3D)
    with torch.no_grad():
        f, lg = pm(torch.zeros(2, 2, 32, 16, 3), train=True)
    assert f.shape == (2, 2048) and lg.shape == (2, 5)


def test_image_clis_refuse_video_backbones(tmp_path):
    """The JAX package's image CLIs build the named model and run it on
    4-D crops, where the 3-D model fails; the port's stop at the
    parser."""
    from reid_tpu_torch import cli

    jm = jbuild("video_resnet50", num_classes=4)
    crops = jnp.zeros((2, 64, 32, 3))
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), crops,
                                       train=True))
    # flax runs a 4-D batch as one unbatched clip of 2 frames: the
    # feature is as wide as the crop batch and no row is an embedding,
    # so the CLIs' [feat || logits] concatenation fails
    feat, logits = jax.eval_shape(
        lambda vv: jm.apply(vv, crops, train=False), v)
    assert feat.shape == (2,) and logits.shape == (4,)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda vv: jnp.concatenate(
            jm.apply(vv, crops, train=False), axis=1), v)
    for name in ("video_resnet50", "video_resnet18"):
        with pytest.raises(SystemExit):
            cli.track_main(["--detections", str(tmp_path / "det.txt"),
                            "--backbone", name], device="cpu")
        with pytest.raises(SystemExit):
            cli.inference_main(["--root", str(tmp_path), "--backbone",
                                name], device="cpu")
        with pytest.raises(SystemExit):
            cli.train_main(["--root", str(tmp_path), "--backbone", name],
                           device="cpu")
