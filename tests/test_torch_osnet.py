"""OSNet (`osnet`, `osnet_x1_0`, `osnet_x0_5`, `osnet_x0_25`) and PLR-OSNet
(`plr_osnet`) in the port against the JAX package's, in eval and train
mode and in int8, with their blocks, the attention modules, the serving
embed and `convert_osnet`; the PLR train step and MADGRAD are in
tests/test_torch_plr_train.py.

Weights are the port's random init (a generator seeded 0) with random
running statistics and biases and, where a PAM module is in the tree, a
non-zero `gamma` (at its init of 0 the attention branch is invisible),
carried to JAX as flax variables; each tree equals the flax init's
(`jax.eval_shape`, so no init is compiled).

  * Every new block bit-equal in bf16 to the jitted flax block:
    `LightConv3x3`, `ChannelGate`, `OSBlock` with and without `down`,
    `SEModule`, `PAMModule`, `AttentionModule`, `MCALayer` (8x6 maps).
  * `osnet_x0_25` in eval mode at 80x40: f32 within rtol = atol = 1e-4;
    bf16 within 2^-6 of the largest magnitude of flax's bf16 output, a
    cosine >= 0.99998 a row and an L2 distance from flax's f32 output at
    most 1.25x flax's own bf16 program's (ROADMAP C's whole-model limits:
    the blocks are bit-equal, and at 80x40 a block's f32 depthwise conv ->
    BatchNorm sums in another order than XLA's conv, flipping a bf16
    rounding on a few outputs in 10,000 of the first block; read 0.0027
    / 0.0006 of the largest, 1 - 6.3e-6 / 1 - 6e-8, 1.01x / 1.00x).
  * `plr_osnet` at 80x40, where the strips are uneven (rows 0:1, 1:2, 2:3,
    3:5 of 5): eval mode in f32 (1e-4) and bf16 (the same limits; read
    0.0076 / 0.0055 / 0.0043, 1 - 8.1e-6 / 1 - 1.5e-5 / 1 - 2.6e-6), the
    cosine at 0.99995 (`COS_BF16` says why), with `att1` / `att2` inside
    the trunk bit-equal on flax's own inputs; train mode in f32 (a batch
    of 8), the four outputs and the new batch statistics at least as
    close to flax's float64 program as the jitted f32 one is, and within
    1e-2 of the latter.
  * int8 `osnet_x0_25` at 64x32 against `quantized_apply` with the same
    QuantState (the JAX kernel routes forced on through their
    references): every call of each int8 layer, the depthwise convs among
    them, gives on the int8 input it had in the jitted JAX program the
    same integer accumulator, and from it the same output, bit for bit;
    neither package takes K1 or the fused block, and the whole output is
    bit-equal (the last stream sum of a block reaches conv3's quantizer
    unrounded, as in the compiled JAX program).
  * The serving embed of `plr_osnet` is the 2,560-wide feature alone, in
    the track CLI's `build_embed`, `embed_with_flip` (equal to the JAX
    package's) and `make_embed_fn`; without the TTA flip both packages
    refuse it.
  * `convert_osnet` on the torchreid-layout OSNet of
    tests/test_torch_convert_osnet.py gives the tree JAX's converter
    gives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.utils.quantize as jqz
from reid_tpu.models import attention_modules as ja
from reid_tpu.models import build_model as jbuild
from reid_tpu.models import osnet as jo
from reid_tpu_torch.models import attention_modules as ta
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models import osnet as to
from reid_tpu_torch.utils import quantize as tqz
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              quant_state_from_flax,
                                              torch_state_dict)
from test_torch_attention import close, flax_eval, flax_init, port_eval
from test_torch_attention import randomize as randomize_stats
from test_torch_cares import cosine_rows
from test_torch_quantize import force_jax_routes
from test_torch_train_data import two_torch_threads  # noqa: F401

NAMES = ["osnet", "osnet_x1_0", "osnet_x0_5", "osnet_x0_25", "plr_osnet"]
C = 16
X = np.random.default_rng(0).normal(size=(2, 80, 40, 3)).astype(np.float32)


def randomize(v, seed):
    """Random statistics and biases (test_torch_attention.randomize), and
    every PAM `gamma` drawn from U(0.3, 0.9)."""
    v = randomize_stats(v, seed)
    rng = np.random.default_rng(seed + 100)

    def walk(node):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x)
            elif k == "gamma":
                node[k] = rng.uniform(0.3, 0.9, (1,)).astype(np.float32)
    walk(v["params"])
    return v


def port_variables(name, num_classes=C, seed=1):
    model = build_model(name, num_classes=num_classes, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return randomize(flax_variables(model), seed)


@pytest.mark.parametrize("name", NAMES)
def test_bridge_tree_equals_flax_init(name):
    """Shapes and dtypes (the depthwise kernels (3, 3, 1, C), PAM's f32
    `gamma` (1,)), the widths `max(16, int(c * mult))`, and the way back
    (`torch_state_dict`) exact."""
    jm = jbuild(name, num_classes=C)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)), train=False))
    v = port_variables(name)
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), s.dtype.name),
                                  shapes)
    got = jax.tree_util.tree_map(lambda a: (np.shape(a), a.dtype.name), v)
    assert got == want
    dw = v["params"]["conv2_0"]["conv2_4_3"]["conv2"]["kernel"]
    assert dw.shape[:3] == (3, 3, 1)
    if name == "plr_osnet":
        assert v["params"]["att2"]["pam"]["gamma"].shape == (1,)
    pm = build_model(name, num_classes=C, device="cpu")
    load_flax_variables(pm, v)
    sd = torch_state_dict(flax_variables(pm))
    for k, t in pm.state_dict().items():
        assert sd[k].dtype == t.dtype and torch.equal(sd[k], t), k


def block_input(c, seed=0):
    return np.random.default_rng(seed).normal(size=(2, 8, 6, c)).astype(
        np.float32)


# (flax module at a dtype, port module at a dtype, input channels, whether
# the call takes `train`)
BLOCKS = {
    "light_conv": (lambda dt: jo.LightConv3x3(32, dtype=dt),
                   lambda dt: to.LightConv3x3(32, 32, dt), 32, True),
    "channel_gate": (lambda dt: jo.ChannelGate(32, dtype=dt),
                     lambda dt: to.ChannelGate(32, dtype=dt), 32, False),
    "os_block": (lambda dt: jo.OSBlock(32, dtype=dt),
                 lambda dt: to.OSBlock(32, 32, dtype=dt), 32, True),
    "os_block_down": (lambda dt: jo.OSBlock(64, dtype=dt),
                      lambda dt: to.OSBlock(32, 64, dtype=dt), 32, True),
    "se": (lambda dt: ja.SEModule(64, dtype=dt),
           lambda dt: ta.SEModule(64, dtype=dt), 64, False),
    "pam": (lambda dt: ja.PAMModule(64, dtype=dt),
            lambda dt: ta.PAMModule(64, dtype=dt), 64, True),
    "attention": (lambda dt: ja.AttentionModule(64, dtype=dt),
                  lambda dt: ta.AttentionModule(64, dtype=dt), 64, True),
    "mca": (lambda dt: ja.MCALayer(64, dtype=dt),
            lambda dt: ta.MCALayer(64, dtype=dt), 64, False),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_bf16_bit_equal_flax(block):
    """Each block in bf16 equal to the jitted flax block bit for bit, and
    in f32 within 1e-5 of the output's largest magnitude."""
    jmake, tmake, cin, takes_train = BLOCKS[block]
    kw = dict(train=False) if takes_train else {}
    x = block_input(cin)
    v = flax_init(jmake(jnp.float32), x, **kw)
    v = randomize(v, 7)
    want = flax_eval(jmake(jnp.bfloat16), v, x, jnp.bfloat16, **kw)
    got = port_eval(tmake(torch.bfloat16), v, x, torch.bfloat16)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)
    want = flax_eval(jmake(jnp.float32), v, x, jnp.float32, **kw)
    close(port_eval(tmake(torch.float32), v, x, torch.float32), want, 1e-5)
    if block in ("pam", "attention"):
        # gamma != 0: the attention branch shows
        v0 = jax.tree_util.tree_map(np.asarray, v)
        node = v0["params"]["pam"] if block == "attention" else v0["params"]
        node["gamma"] = np.zeros(1, np.float32)
        bare = flax_eval(jmake(jnp.float32), v0, x, jnp.float32, **kw)
        assert np.abs(bare - want).max() > 1e-2


def test_depthwise_conv_keeps_f32_product():
    """`Conv2d(groups=C, keep_f32=True)` in bf16: the f32 conv of the
    bf16-rounded input and kernel, unrounded; without `keep_f32` that
    product rounded to bf16; flax's depthwise kernel (3, 3, 1, C) lands
    as (C, 1, 3, 3)."""
    from reid_tpu_torch.models.layers import Conv2d
    x = torch.from_numpy(block_input(16))
    conv = Conv2d(16, 16, 3, padding=1, dtype=torch.bfloat16,
                  keep_f32=True, groups=16)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    kernel = flax_variables(conv)["params"]["kernel"]
    assert kernel.shape == (3, 3, 1, 16)
    with torch.no_grad():
        y = conv(x)
        want = torch.nn.functional.conv2d(
            x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
            conv.weight.to(torch.bfloat16).float(), padding=1,
            groups=16).permute(0, 2, 3, 1)
        assert y.dtype == torch.float32 and torch.equal(y, want)
        conv.keep_f32 = False
        assert torch.equal(conv(x), want.to(torch.bfloat16))


@pytest.fixture(scope="module")
def variables():
    return {n: port_variables(n) for n in ("osnet_x0_25", "plr_osnet")}


def flax_apply(name, v, dtype, x=X, train=False):
    jm = jbuild(name, num_classes=C, dtype=dtype)
    if train:
        out, mut = jax.jit(lambda vv, xx: jm.apply(
            vv, xx.astype(dtype), train=True, mutable=["batch_stats"]))(
                v, jnp.asarray(x))
        return flat(out), mut["batch_stats"]
    return flat(jax.jit(lambda vv, xx: jm.apply(vv, xx.astype(dtype),
                                                train=False))(
        v, jnp.asarray(x)))


def flat(out):
    """(feature, logits) with PLR-OSNet's pairs unpacked, as f32 numpy."""
    leaves = []
    for o in out:
        leaves += list(o) if isinstance(o, tuple) else [o]
    return [np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                       np.float32) for t in leaves]


def port_apply(name, v, dtype, x=X, train=False):
    pm = build_model(name, num_classes=C, dtype=dtype, device="cpu")
    load_flax_variables(pm, v)
    with torch.no_grad():
        out = pm(torch.from_numpy(x).to(dtype), train=train)
    return flat(out), pm


@pytest.mark.parametrize("name", ["osnet_x0_25", "plr_osnet"])
def test_eval_matches_flax(variables, name):
    v = variables[name]
    ref = flax_apply(name, v, jnp.float32)
    got, _ = port_apply(name, v, torch.float32)
    widths = [2560, C, C] if name == "plr_osnet" else [512, C]
    assert [g.shape for g in got] == [(2, w) for w in widths]
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    want = flax_apply(name, v, jnp.bfloat16)
    got, _ = port_apply(name, v, torch.bfloat16)
    for g, w, r in zip(got, want, ref):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        assert cosine_rows(g, w).min() >= COS_BF16[name]
        assert np.linalg.norm(g - r) <= 1.25 * np.linalg.norm(w - r)


# the bf16 cosine a row: ROADMAP C's whole-model limit, and for PLR-OSNet a
# looser one. Its PAM modules are bit-equal inside the trunk on the input
# flax gives them (test_plr_attention_in_trunk_bit_equal), but their
# softmax over the energies amplifies the few bf16 roundings that the
# trunk's f32 conv -> norm order moves before them (0.76% of trans2's
# outputs, 7% of att1's): read 1 - 2.0e-5 on the feature
COS_BF16 = {"osnet_x0_25": 0.99998, "plr_osnet": 0.99995}


def test_plr_attention_in_trunk_bit_equal(variables):
    """PLR-OSNet's `att1` and `att2` in bf16 on the inputs the jitted flax
    model gave them (its captured `trans2` / `trans3`, average-pooled)
    equal flax's captured outputs bit for bit."""
    v = variables["plr_osnet"]
    jm = jbuild("plr_osnet", num_classes=C, dtype=jnp.bfloat16)
    _, st = jax.jit(lambda vv, xx: jm.apply(
        vv, xx.astype(jnp.bfloat16), train=False, capture_intermediates=True,
        mutable=["intermediates"]))(v, jnp.asarray(X))
    inter = jax.tree_util.tree_map(np.asarray, st["intermediates"])
    pm = build_model("plr_osnet", num_classes=C, dtype=torch.bfloat16,
                     device="cpu")
    load_flax_variables(pm, v)
    for att, trans in (("att1", "trans2"), ("att2", "trans3")):
        xin = to.avg_pool2(torch.from_numpy(np.asarray(
            inter[trans]["__call__"][0], np.float32)).to(torch.bfloat16))
        with torch.no_grad():
            got = getattr(pm, att)(xin).float().numpy()
        np.testing.assert_array_equal(
            got, np.asarray(inter[att]["__call__"][0], np.float32))


def test_plr_osnet_train_forward_matches_flax():
    """Train mode at 80x40 in f32, a batch of 8, the norms at their init
    and PAM's `gamma` non-zero: (v1, v2), (y1, y2) within 5e-3 of each
    tensor's largest magnitude of the same flax model run in float64 and
    at least as close to it as the jitted f32 flax program, and within
    1e-2 of that program; the batch statistics that the call folds into
    the running ones likewise (each at least as close to float64, within
    1e-6 of its largest magnitude, as the jitted program's). Train-mode
    BatchNorm's fast variance E[x^2] - E[x]^2 cancels on the 1-D heads (8
    values a channel) and at stage 4 (5x2 pixels), and PAM's softmax,
    normalized on batch statistics, amplifies it: the jitted f32 program
    lies 4.0e-3 - 9.6e-3 from float64 (2.2e-4 - 4.8e-4 with `gamma` = 0),
    the port 5.9e-4 - 1.9e-3 (4.1e-5 - 9.0e-5)."""
    model = build_model("plr_osnet", num_classes=C, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    v = flax_variables(model)
    for att in ("att1", "att2"):
        v["params"][att]["pam"]["gamma"] = np.asarray([0.6], np.float32)
    x = np.random.default_rng(1).normal(size=(8, 80, 40, 3)).astype(
        np.float32)
    want, stats = flax_apply("plr_osnet", v, jnp.float32, x, train=True)
    got, pm = port_apply("plr_osnet", v, torch.float32, x, train=True)
    with jax.enable_x64(True):
        jm = jbuild("plr_osnet", num_classes=C, dtype=jnp.float64)
        out, mut = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, train=True, mutable=["batch_stats"]))(
                jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       v), jnp.asarray(x, jnp.float64))
        exact = [np.asarray(o, np.float64) for o in flat(out)]
        exact_stats = torch_state_dict({"batch_stats": jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"])})
    assert [g.shape for g in got] == [(8, 2048), (8, 512), (8, C), (8, C)]
    for g, w, e in zip(got, want, exact):
        close(g, e, 5e-3)
        assert np.abs(g - e).max() <= np.abs(w - e).max()
        close(g, w, 1e-2)
    want_stats = torch_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats)})
    assert want_stats.keys() == dict(pm.named_buffers()).keys()
    for bname, b in pm.named_buffers():
        e = exact_stats[bname].double().numpy()
        err = np.abs(b.double().numpy() - e).max()
        assert err <= np.abs(want_stats[bname].double().numpy() - e).max() \
            + 1e-6 * np.abs(e).max(), bname
        close(b.numpy(), want_stats[bname].numpy(), 1e-2)


def record_accumulators(monkeypatch):
    """Every call of every int8 layer inside the jitted JAX program, by
    path, in order: its int8 input and s32 accumulator (read where
    `lax.conv_general_dilated` / `lax.dot_general` compute it with
    preferred_element_type int32) and its output. The layer's input
    itself is not what to hand the port: where the compiled program keeps
    excess precision (the last of OSBlock's stream sums), the value a
    callback reads is rounded and the one quantized is not."""
    records = {}
    current = []
    lax_ops = {"conv": jax.lax.conv_general_dilated,
               "dot": jax.lax.dot_general}

    def put(path, key, value):
        records.setdefault(path, {}).setdefault(key, []).append(value)

    def op(kind):
        def call(lhs, rhs, *a, **kw):
            out = lax_ops[kind](lhs, rhs, *a, **kw)
            if kw.get("preferred_element_type") == jnp.int32 and current:
                path = current[-1]
                jax.debug.callback(lambda q, acc: put(path, "xq_acc", (
                    np.asarray(q), np.asarray(acc))), lhs, out, ordered=True)
            return out
        return call

    def layer(fn):
        def call(m, x, kq, sw, sx):
            path = jqz._path_str(m)
            current.append(path)
            try:
                out = fn(m, x, kq, sw, sx)
            finally:
                current.pop()
            jax.debug.callback(lambda o: put(path, "out", (
                np.asarray(o, np.float32), o.dtype.name)), out, ordered=True)
            return out
        return call
    monkeypatch.setattr(jax.lax, "conv_general_dilated", op("conv"))
    monkeypatch.setattr(jax.lax, "dot_general", op("dot"))
    monkeypatch.setattr(jqz, "_quantized_conv", layer(jqz._quantized_conv))
    monkeypatch.setattr(jqz, "_quantized_dense",
                        layer(jqz._quantized_dense))
    return records


def test_int8_osnet_equals_jax_quantized_apply(variables, monkeypatch):
    name = "osnet_x0_25"
    x = X[:, :64, :32]
    v = variables[name]
    jm = jbuild(name, num_classes=C, dtype=jnp.bfloat16)
    calls = force_jax_routes(monkeypatch)
    qs = jqz.quantize(jm, v, [jnp.asarray(x)], train=False)
    records = record_accumulators(monkeypatch)
    fj, lj = jax.jit(lambda vv, xx: jqz.quantized_apply(
        jm, vv, qs, xx.astype(jnp.bfloat16), train=False))(v, jnp.asarray(x))
    jax.effects_barrier()
    assert calls == {"qconv": 0, "qblock": 0}

    pm = build_model(name, num_classes=C, dtype=torch.bfloat16, device="cpu")
    load_flax_variables(pm, v)
    qm = tqz.quantized_model(pm, quant_state_from_flax(qs, "cpu"))
    layers = dict(tqz.quantizable(pm))
    assert set(layers) == set(qs.kernels) == set(records)
    depthwise = [p for p, m in layers.items()
                 if getattr(m, "groups", 1) > 1]
    assert len(depthwise) == 6 * 10          # 10 a block, 6 blocks
    assert not any(getattr(m, "route", False) for m in qm.modules())
    assert not any(isinstance(m, tqz.QSEBasicBlock) for m in qm.modules())
    with torch.no_grad():
        for path, rec in records.items():
            layer = qm.get_submodule(path.replace("/", "."))
            # the shared gate: one call a stream
            assert len(rec["xq_acc"]) == len(rec["out"]) == (
                4 if "/gate/" in path else 1), path
            for (xq, acc), (out, dtype) in zip(rec["xq_acc"], rec["out"]):
                got = layer.acc(torch.from_numpy(np.array(xq)))
                np.testing.assert_array_equal(got.numpy(), acc.astype(
                    np.float32), err_msg=path)
                got = tqz.scale_add(got, layer.scale, layer.bias).to(
                    getattr(torch, dtype))
                np.testing.assert_array_equal(got.float().numpy(), out,
                                              err_msg=path)
        ft, lt = qm(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(ft.float().numpy(),
                                  np.asarray(fj, np.float32))
    np.testing.assert_array_equal(lt.float().numpy(),
                                  np.asarray(lj, np.float32))


def test_grouped_int8_accumulator_is_exact():
    """A depthwise int8 conv at the extremes (every input and weight
    +-127): the accumulator is the integer sum, on the route that the card
    takes in f32 as on the CPU's float64."""
    xq = torch.full((1, 4, 4, 8), 127, dtype=torch.int8)
    wq = torch.full((8, 1, 3, 3), -127, dtype=torch.int8)
    for dt in (torch.float64, torch.float32):
        acc = torch.nn.functional.conv2d(
            xq.permute(0, 3, 1, 2).to(dt), wq.to(dt), padding=1, groups=8)
        assert float(acc[0, 0, 1, 1]) == -9 * 127 * 127
    got = tqz.grouped_acc(xq, wq, 1, 1, 8)
    assert float(got[0, 1, 1, 0]) == -9 * 127 * 127
    assert float(got[0, 0, 0, 0]) == -4 * 127 * 127


# the serving embed


@pytest.fixture(scope="module")
def plr_states():
    """A JAX train state of `plr_osnet` (its apply_fn for the JAX package's
    serving functions) and the port's model, one set of weights."""
    import reid_tpu.config as jcfg
    from reid_tpu.train.state import ReIDTrainState
    v = port_variables("plr_osnet", 6, seed=3)
    jm = jbuild("plr_osnet", num_classes=6)
    state = ReIDTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=None, loss_state=None,
        center_opt_state=None, xbm=None, apply_fn=jm.apply, tx=None,
        center_tx=None)
    pm = build_model("plr_osnet", num_classes=6, device="cpu")
    load_flax_variables(pm, v)
    del jcfg
    return state, pm, v


def test_plr_embed_with_flip_is_feature_only(plr_states):
    from reid_tpu.train.steps import embed_with_flip as jembed
    from reid_tpu_torch.train.steps import embed_single, embed_with_flip
    state, pm, _ = plr_states
    x = np.random.default_rng(2).normal(size=(3, 64, 32, 3)).astype(
        np.float32)
    want = np.asarray(jembed(state.apply_fn, state.params, state.batch_stats,
                             jnp.asarray(x)))
    with torch.no_grad():
        got = embed_with_flip(pm, torch.from_numpy(x)).numpy()
        with pytest.raises(ValueError, match="tta_flip"):
            embed_single(pm, torch.from_numpy(x))
    assert got.shape == want.shape == (3, 2560)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_plr_serving_embed_is_feature_only(plr_states, tmp_path):
    """`make_embed_fn` with the TTA flip gives what JAX's gives; without it
    the JAX package fails on the logits pair and the port refuses, naming
    the reason. The track CLI's `build_embed` embeds the feature alone."""
    from reid_tpu.eval.serving import make_embed_fn as jmake_embed_fn
    from reid_tpu_torch import cli
    from reid_tpu_torch.eval.serving import make_embed_fn
    from reid_tpu_torch.utils.flax_bridge import save_npz
    state, pm, v = plr_states
    img = np.random.default_rng(4).uniform(0, 255, (2, 64, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmake_embed_fn(state)(jnp.asarray(img)))
    got = make_embed_fn(pm)(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 2560)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(AttributeError):
        jmake_embed_fn(state, tta_flip=False)(jnp.asarray(img))
    with pytest.raises(ValueError, match="tta_flip"):
        make_embed_fn(pm, tta_flip=False)(torch.from_numpy(img))
    ckpt = str(tmp_path / "plr.npz")
    save_npz(ckpt, v)
    fn, _ = cli.build_embed("plr_osnet", 6, (64, 32), "cpu", ckpt=ckpt)
    with torch.no_grad():
        emb = fn(torch.from_numpy(img[:, :, :, ::-1].copy()))
    assert emb.shape == (2, 2560)
    np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_convert_osnet_matches_jax():
    """The port's `convert_osnet` puts the torchreid-layout OSNet x1.0's
    trunk and feature head into the port's OSNet exactly where JAX's
    converter puts them into the flax tree (the classifier keeps its
    init), and the converted models agree in f32."""
    from reid_tpu.utils.torch_convert import convert_osnet as jconvert
    from reid_tpu_torch.utils.torch_convert import convert_osnet
    from test_torch_convert_osnet import TOSNet
    tm = TOSNet().eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                mod.running_mean.uniform_(-0.1, 0.1, generator=gen)
                mod.running_var.uniform_(0.9, 1.1, generator=gen)
    sd = tm.state_dict()
    pm = build_model("osnet", num_classes=5, device="cpu")
    init = flax_variables(pm)
    loaded = convert_osnet(sd, pm)
    want = jax.tree_util.tree_map(np.asarray, jconvert(
        {k: v.numpy() for k, v in sd.items()}, init))
    got = flax_variables(pm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    np.testing.assert_array_equal(got["params"]["classifier"]["kernel"],
                                  init["params"]["classifier"]["kernel"])
    n_copied = sum(t.numel() > 0 for t in sd.values()
                   if t.dtype != torch.int64)
    assert loaded == n_copied
    x = np.random.default_rng(1).normal(size=(2, 80, 40, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        feat, _ = pm(torch.from_numpy(x))
    np.testing.assert_allclose(feat.numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="no tensor"):
        convert_osnet({}, pm)


@pytest.mark.parametrize("int8", [False, True])
def test_plr_artifact_serves_as_in_process(plr_states, tmp_path, int8):
    """`export_reid_artifact` of `plr_osnet` (f32, and int8 from one
    calibration), as the JAX package's exports it (checked on the CPU:
    both with the TTA flip; without it its trace fails on the logits
    pair, and the port's export refuses): the loaded artifact equals
    serving the model in process at two batch sizes, 2,560 wide, with
    neither K1 nor the fused block in the graph."""
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             export_reid_artifact,
                                             load_serving_fn, make_embed_fn,
                                             make_int8_embed_fn)
    _, pm, _ = plr_states
    gen = torch.Generator().manual_seed(0)
    path = str(tmp_path / "plr.pt2")
    qstate = None
    if int8:
        qstate = calibrate_serving_qstate(
            pm, torch.rand((4, 64, 32, 3), generator=gen) * 255)
    ep = export_reid_artifact(pm, path, 64, 32, qstate=qstate)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert not any("conv3x3_s8" in t or "se_basic_block_s8" in t
                   for t in targets)
    serve = make_int8_embed_fn(pm, qstate=qstate) if int8 else \
        make_embed_fn(pm)
    fn = load_serving_fn(path)
    for b in (1, 3):
        x = torch.rand((b, 64, 32, 3), generator=gen) * 255
        with torch.no_grad():
            want = serve(x)
            got = fn(x)
        assert got.shape == (b, 2560)
        assert torch.equal(got, want)
    if not int8:
        with pytest.raises(ValueError, match="tta_flip"):
            export_reid_artifact(pm, str(tmp_path / "no_flip.pt2"), 64, 32,
                                 tta_flip=False)
