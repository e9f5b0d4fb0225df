"""The port's torchvision-style ResNets (`reid_tpu_torch.models.baseline`:
"baseline", "resnet50", "agw") against `reid_tpu.models.baseline` in eval
mode, their flax bridge, the torchvision converter and their int8 route.

Weights are the port's random init (a generator seeded 0) with random
running statistics (mean N(0, 0.1), var U(0.5, 1.5)) and, in agw, random
`w_bn` scales (a fresh non-local block is the identity), carried to JAX as
flax variables (`flax_variables`); the tree equals the one flax's own init
gives (`jax.eval_shape`, so no init is compiled). Inputs: 2 images of
64x32 from a numpy seed.

Tolerances:
  * float32, whole model: rtol = atol = 1e-4 of the tensor's largest
    magnitude (random statistics let activations grow to ~850 through
    ResNet50's 16 blocks; read: within 3e-6 of it).
  * bfloat16, one block (basic, bottleneck, non-local): bit-equal. Every
    conv and dense layer whose product a BatchNorm reads keeps it in f32,
    and the attention's logits are computed in f32 from the bf16 operands,
    as the compiled flax program does (test_torch_models.py has the SERes18
    reading).
  * bfloat16, whole baseline / resnet50: within 2^-7 of the largest
    magnitude and a cosine >= 0.99995 per row (read: 0.0041 / 0.0062,
    1 - 1.1e-5 / 1 - 1.5e-5). Reductions and the f32 summation order still
    move a bf16 rounding now and then, over 20 / 53 layers.
  * bfloat16, whole agw: at a random init the non-local logits reach the
    thousands, so its softmax is near one-hot and a bf16 rounding flips
    the pixel it takes, in either framework. Held against the f32 flax
    program as flax's own bf16 program is: the port's L2 error at most
    2x flax's.
  * int8: the quantized baseline (plain K1 on the CPU) equals
    `quantized_apply` with the same QuantState bit for bit, its routes
    forced on through the JAX package's references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.utils.quantize as jqz
from reid_tpu.models import build_model as jbuild
from reid_tpu.models.baseline import BasicBlock as JBasic
from reid_tpu.models.baseline import Bottleneck as JBottleneck
from reid_tpu.models.baseline import NonLocalBlock as JNonLocal
from reid_tpu.utils.torch_convert import \
    convert_torchvision_resnet as jconvert
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models import baseline as tb
from reid_tpu_torch.models.layers import Conv2d
from reid_tpu_torch.utils import quantize as tqz
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              quant_state_from_flax,
                                              torch_state_dict)
from reid_tpu_torch.utils.torch_convert import convert_torchvision_resnet
from test_torch_models import _random_stats
from test_torch_quantize import force_jax_routes
from test_torch_train_data import two_torch_threads  # noqa: F401

NAMES = ["baseline", "resnet50", "agw"]
C = 16
X = np.random.default_rng(0).normal(size=(2, 64, 32, 3)).astype(np.float32)


def random_variables(model, seed=1):
    """`model`'s flax variables with random running statistics and, in
    every non-local block, random `w_bn` scales."""
    v = flax_variables(model)
    rng = np.random.default_rng(seed)
    v["batch_stats"] = _random_stats(v["batch_stats"], rng)
    for name, m in model.named_modules():
        if isinstance(m, tb.NonLocalBlock):
            node = v["params"]
            for part in name.split(".") if name else []:
                node = node[part]
            node["w_bn"]["scale"] = rng.normal(
                size=node["w_bn"]["scale"].shape).astype(np.float32)
            for c in ("g", "theta", "phi", "w"):
                node[c]["bias"] = rng.normal(
                    0, 0.1, node[c]["bias"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def variables():
    return {n: random_variables(build_model(
        n, num_classes=C, device="cpu",
        generator=torch.Generator().manual_seed(0))) for n in NAMES}


def flax_apply(name, v, dtype):
    jm = jbuild(name, num_classes=C, dtype=dtype)
    f, lg = jax.jit(lambda vv, x: jm.apply(vv, x.astype(dtype),
                                           train=False))(v, jnp.asarray(X))
    return np.asarray(f, np.float32), np.asarray(lg, np.float32)


def port_apply(name, v, dtype):
    pm = build_model(name, num_classes=C, dtype=dtype, device="cpu")
    load_flax_variables(pm, v)
    with torch.no_grad():
        f, lg = pm(torch.from_numpy(X).to(dtype))
    assert f.dtype == lg.dtype == dtype
    return f.float().numpy(), lg.float().numpy()


@pytest.fixture(scope="module")
def f32_outputs(variables):
    return {n: flax_apply(n, variables[n], jnp.float32) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_bridge_tree_equals_flax_init(variables, name):
    """The port's tree is flax's (`eval_shape` of the init), and the way
    back (`torch_state_dict`) is exact."""
    jm = jbuild(name, num_classes=C)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)), train=False))
    v = variables[name]
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    got = jax.tree_util.tree_map(np.shape, v)
    assert got == want
    pm = build_model(name, num_classes=C, device="cpu")
    load_flax_variables(pm, v)
    sd = torch_state_dict(flax_variables(pm))
    for k, t in pm.state_dict().items():
        assert torch.equal(sd[k], t), k


@pytest.mark.parametrize("name", NAMES)
def test_eval_f32_matches_flax(variables, f32_outputs, name):
    want_f, want_l = f32_outputs[name]
    got_f, got_l = port_apply(name, variables[name], torch.float32)
    width = 2048 if name == "agw" else 512
    assert got_f.shape == (2, width) and got_l.shape == (2, C)
    for got, want in ((got_f, want_f), (got_l, want_l)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4,
                                   atol=1e-4)


def cosine_rows(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("name", NAMES)
def test_eval_bf16_matches_flax(variables, f32_outputs, name):
    want = flax_apply(name, variables[name], jnp.bfloat16)
    got = port_apply(name, variables[name], torch.bfloat16)
    for g, w, ref in zip(got, want, f32_outputs[name]):
        assert np.isfinite(g).all()
        if name == "agw":
            assert np.linalg.norm(g - ref) <= 2 * np.linalg.norm(w - ref)
            continue
        assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()
        assert cosine_rows(g, w).min() >= 0.99995


def _block_variables(module, seed):
    """A torch block's flax variables: kaiming convs from `seed`, random
    statistics."""
    g = torch.Generator().manual_seed(seed)
    for c in module.modules():
        if isinstance(c, Conv2d):
            c.reset_parameters(g, init="lecun" if c.bias is not None
                               else "kaiming")
    return random_variables(module, seed)


@pytest.mark.parametrize("kind,cin,planes,stride,down", [
    ("basic", 16, 16, 1, False), ("basic", 8, 16, 2, True),
    ("bottleneck", 16, 8, 1, True), ("bottleneck", 32, 8, 2, True),
    ("bottleneck", 32, 8, 1, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_flax(kind, cin, planes, stride, down, dtype):
    tcls, jcls = ((tb.BasicBlock, JBasic) if kind == "basic"
                  else (tb.Bottleneck, JBottleneck))
    x = np.random.default_rng(1).normal(size=(3, 8, 6, cin)).astype(
        np.float32)
    v = _block_variables(tcls(cin, planes, stride, down), 3)
    jm = jcls(planes, strides=stride, downsample=down,
              dtype=getattr(jnp, dtype))
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x).astype(getattr(jnp, dtype))), np.float32)
    pm = tcls(cin, planes, stride, down, dtype=getattr(torch, dtype))
    load_flax_variables(pm, v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(getattr(torch, dtype))).float()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_local_block_matches_flax(dtype):
    """With a non-zero `w_bn` (at its zero init the block is the
    identity, which a test would not see)."""
    c = 32
    x = np.random.default_rng(0).normal(size=(3, 8, 4, c)).astype(
        np.float32)
    v = _block_variables(tb.NonLocalBlock(c), 0)
    assert np.abs(v["params"]["w_bn"]["scale"]).min() > 0
    jm = JNonLocal(c, dtype=getattr(jnp, dtype))
    xin = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, xin), np.float32)
    assert np.abs(want - np.asarray(xin, np.float32)).max() > 0.1
    pm = tb.NonLocalBlock(c, dtype=getattr(torch, dtype))
    load_flax_variables(pm, v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(getattr(torch, dtype))).float()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_fresh_non_local_block_is_identity():
    m = tb.ResNetReID(num_classes=C, block="bottleneck", blocks=(1, 1, 1, 1),
                      non_local=True, pooling="gem", bottleneck_dim=0)
    m.init_weights(torch.Generator().manual_seed(0))
    for nl in (m.nl2, m.nl3):
        assert not nl.w_bn.weight.any()
        assert nl.g.bias is not None and nl.w.keep_f32
    x = torch.randn(2, 8, 4, 512)
    with torch.no_grad():
        assert torch.equal(m.nl2(x), x)


def test_unported_backbones_raise_key_error():
    # every name of the JAX registry is ported: these are in neither
    for name in ("video_resnet34", "video_resnet101"):
        with pytest.raises(KeyError, match="agw"):
            build_model(name, num_classes=4, device="cpu")


def torchvision_state_dict(blocks, bottleneck, seed=0):
    """A random state dict in torchvision's ResNet layout (resnet18 /
    resnet50 names and shapes, with fc and num_batches_tracked)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name] = torch.from_numpy(rng.normal(
            0, 0.05, (cout, cin, k, k)).astype(np.float32))

    def bn(name, c):
        sd[name + ".weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c)
                                                .astype(np.float32))
        for leaf in ("bias", "running_mean"):
            sd[f"{name}.{leaf}"] = torch.from_numpy(rng.normal(
                0, 0.1, c).astype(np.float32))
        sd[name + ".running_var"] = torch.from_numpy(rng.uniform(
            0.5, 1.5, c).astype(np.float32))
        sd[name + ".num_batches_tracked"] = torch.tensor(7)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    exp = 4 if bottleneck else 1
    cin = 64
    for li, (p, nb) in enumerate(zip((64, 128, 256, 512), blocks), 1):
        for b in range(nb):
            t = f"layer{li}.{b}"
            if bottleneck:
                conv(t + ".conv1.weight", p, cin, 1)
                conv(t + ".conv2.weight", p, p, 3)
                conv(t + ".conv3.weight", p * 4, p, 1)
                for i, c in ((1, p), (2, p), (3, p * 4)):
                    bn(f"{t}.bn{i}", c)
            else:
                conv(t + ".conv1.weight", p, cin, 3)
                conv(t + ".conv2.weight", p, p, 3)
                bn(t + ".bn1", p)
                bn(t + ".bn2", p)
            if b == 0 and (li > 1 or bottleneck):
                conv(t + ".downsample.0.weight", p * exp, cin, 1)
                bn(t + ".downsample.1", p * exp)
            cin = p * exp
    sd["fc.weight"] = torch.zeros((1000, cin))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("blocks,bottleneck", [((2, 2, 2, 2), False),
                                               ((1, 1, 1, 1), True)])
def test_convert_torchvision_resnet_matches_jax(blocks, bottleneck):
    """Both converters on one random torchvision-layout state dict
    (resnet18's, and a bottleneck trunk of one block a stage with agw's
    head): the port's model, read back as flax variables, equals JAX's
    converted tree; the head keeps its init."""
    sd = torchvision_state_dict(blocks, bottleneck)
    kw = (dict(block="bottleneck", non_local=True, pooling="gem",
               bottleneck_dim=0) if bottleneck else dict(block="basic"))
    pm = tb.ResNetReID(num_classes=C, blocks=blocks, **kw).init_weights(
        torch.Generator().manual_seed(0))
    v = random_variables(pm)
    want = jconvert({k: t.numpy() for k, t in sd.items()}, v, blocks,
                    bottleneck)
    load_flax_variables(pm, v)
    loaded = convert_torchvision_resnet(sd, pm, blocks, bottleneck)
    n_bn = sum(k.endswith("running_var") for k in sd)
    n_conv = sum(t.ndim == 4 for t in sd.values())
    assert loaded == n_conv + 4 * n_bn
    got = flax_variables(pm)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf),
                                      err_msg=str(path))
    assert torch.equal(pm.conv1.weight, sd["conv1.weight"])
    np.testing.assert_array_equal(got["params"]["classifier"]["kernel"],
                                  v["params"]["classifier"]["kernel"])
    head_only = {k: t for k, t in sd.items() if k.startswith("fc.")}
    with pytest.raises(ValueError, match="no tensor matched"):
        convert_torchvision_resnet(head_only, pm, blocks, bottleneck)


# K1 sites of the int8 baseline: the stride-1 3x3 convs with Cin and Cout
# multiples of 128
BASELINE_K1 = ["layer2_0/conv2", "layer2_1/conv1", "layer2_1/conv2",
               "layer3_0/conv2", "layer3_1/conv1", "layer3_1/conv2",
               "layer4_0/conv1", "layer4_0/conv2", "layer4_1/conv1",
               "layer4_1/conv2"]


def test_int8_baseline_equals_jax_quantized_apply(variables, monkeypatch):
    v = variables["baseline"]
    jm = jbuild("baseline", num_classes=C, dtype=jnp.bfloat16)
    calls = force_jax_routes(monkeypatch)
    qs = jqz.quantize(jm, v, [jnp.asarray(X)], train=False)
    fj, lj = jax.jit(lambda vv, xx: jqz.quantized_apply(
        jm, vv, qs, xx.astype(jnp.bfloat16), train=False))(v, jnp.asarray(X))
    assert calls == {"qconv": len(BASELINE_K1), "qblock": 0}

    pm = build_model("baseline", num_classes=C, dtype=torch.bfloat16,
                     device="cpu")
    load_flax_variables(pm, v)
    qm = tqz.quantized_model(pm, quant_state_from_flax(qs, "cpu"))
    convs = {p: m for p, m in tqz.quantizable(pm)}
    routed = sorted(p for p in convs if getattr(
        qm.get_submodule(p.replace("/", ".")), "route", False))
    assert routed == sorted(BASELINE_K1)
    # the rest run on the im2col route: the stem, layer1's four 64-channel
    # convs, the stride-2 conv1 and the downsample of layer2_0 and
    # layer3_0, layer4_0's downsample and the classifier; K2 takes no block
    assert len(convs) - len(routed) == 1 + 4 + 2 + 2 + 1 + 1
    assert not any(isinstance(m, tqz.QSEBasicBlock) for m in qm.modules())
    with torch.no_grad():
        ft, lt = qm(torch.from_numpy(X).to(torch.bfloat16))
    np.testing.assert_array_equal(ft.float().numpy(),
                                  np.asarray(fj, np.float32))
    np.testing.assert_array_equal(lt.float().numpy(),
                                  np.asarray(lj, np.float32))


def test_int8_artifact_serves_as_in_process(tmp_path):
    """The int8 baseline's serving artifact (`torch.export`, K1 as the
    custom op `reid_tpu_torch::conv3x3_s8`) at 64x32 with a dynamic batch,
    loaded in process, equals serving the same model in process bit for
    bit at two batch sizes, as test_torch_export.py holds SERes18's. The
    new backbones export with no code of their own."""
    from reid_tpu_torch.eval.serving import (export_reid_artifact,
                                             load_serving_fn,
                                             make_int8_embed_fn)

    model = build_model("baseline", num_classes=6, device="cpu")
    load_flax_variables(model, random_variables(model))
    gen = torch.Generator().manual_seed(0)
    calib = torch.rand((4, 64, 32, 3), generator=gen) * 255
    path = str(tmp_path / "baseline.pt2")
    ep = export_reid_artifact(model, path, 64, 32, int8_calib=calib)
    assert any("conv3x3_s8" in str(n.target) for n in ep.graph.nodes
               if n.op == "call_function")
    serve = make_int8_embed_fn(model, calib)
    fn = load_serving_fn(path)
    for b in (1, 3):
        x = torch.rand((b, 64, 32, 3), generator=gen) * 255
        with torch.no_grad():
            want = serve(x)
            got = fn(x)
        assert got.shape == (b, 512 + 6)
        assert torch.equal(got, want)
