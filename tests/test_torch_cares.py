"""CARes18 and EMARes18 (`build_model("cares18" | "emares18")`, the SERes18
skeleton with triplet / EMA block attention) and SERes18 with BatchRenorm
(`renorm=True`) in the port against the JAX package's in eval mode and
int8; one train step of each is in tests/test_torch_cares_train.py.

Weights are the port's random init (a generator seeded 0) with random
running statistics and random conv biases, carried to JAX as flax
variables; the tree equals the one flax's own init gives
(`jax.eval_shape`, so no init is compiled).

  * Eval mode at 80x40 (the XLA:CPU conv cliff), 2 images: f32 within
    rtol = atol = 1e-4 (test_torch_models.py's SERes18 limit). bf16:
    within 2^-6 of the largest magnitude of flax's bf16 output, a cosine
    >= 0.99998 a row, and an L2 distance from flax's f32 output at most
    1.25x flax's own bf16 program's. The blocks alone are bit-equal
    (test_torch_attention.py), and so is the triplet attention inside the
    trunk given flax's input; at 80x40 each block's f32 conv -> BatchNorm
    sums a longer product in another order than XLA's conv, and the bf16
    rounding after the norm flips on about 1% of a block's outputs, the
    same in SERes18. Read (feature, logits): cares18 0.0085 / 0.0063 of
    the largest, cosine 1 - 1.6e-5 / 1 - 1.2e-5, L2 1.02x / 1.05x
    flax's; emares18 0.0052 / 0.0040, 1 - 7.8e-6 / 1 - 1.6e-5, 1.00x /
    1.13x; SERes18 with the same kind of weights 0.0057 / 0.0037, 1 -
    7.1e-6 / 1 - 1.0e-5, 0.99x / 0.99x.
  * `--int8` at 64x32 against `quantized_apply` with the same QuantState,
    the JAX routes forced on through their references (kernels' plain
    versions on the CPU): each int8 layer (all 10 K1 sites, the stem,
    the stride-2 and 64-channel convs, the triplet gates' 7x7 convs,
    EMA's convs with their biases, the classifier) on the input it had in
    the jitted JAX program gives its output bit for bit, so every integer
    accumulator is exact; JAX takes K1 exactly 10 times and the fused
    block never, the port routes the same 10 convs to K1 and fuses no
    block; a renorm SERes18 fuses none either, a plain one its four. The
    whole output: cares18 bit-equal, emares18 at a cosine >= 0.9995 a
    row (`COS_INT8_EMA` says why).

The int8 `torch.export` artifacts are in tests/test_torch_cares_export.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.utils.quantize as jqz
from reid_tpu.models import build_model as jbuild
from reid_tpu_torch.models import build_model
from reid_tpu_torch.utils import quantize as tqz
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              quant_state_from_flax,
                                              torch_state_dict)
from test_torch_attention import randomize
from test_torch_quantize import force_jax_routes
from test_torch_train_data import two_torch_threads  # noqa: F401

NAMES = ["cares18", "emares18"]
C = 16
X = np.random.default_rng(0).normal(size=(2, 80, 40, 3)).astype(np.float32)
# the stride-1 3x3 convs with Cin and Cout multiples of 128: K1's sites
K1_SITES = ["block21/conv2", "block22/conv1", "block22/conv2",
            "block31/conv2", "block32/conv1", "block32/conv2",
            "block41/conv1", "block41/conv2", "block42/conv1",
            "block42/conv2"]


def port_variables(name, num_classes, renorm=False, seed=1):
    model = build_model(name, num_classes=num_classes, device="cpu",
                        renorm=renorm,
                        generator=torch.Generator().manual_seed(0))
    return randomize(flax_variables(model), seed)


@pytest.fixture(scope="module")
def variables():
    return {n: port_variables(n, C) for n in NAMES}


def flax_apply(name, v, dtype, x=X):
    jm = jbuild(name, num_classes=C, dtype=dtype)
    f, lg = jax.jit(lambda vv, xx: jm.apply(vv, xx.astype(dtype),
                                            train=False))(v, jnp.asarray(x))
    return np.asarray(f, np.float32), np.asarray(lg, np.float32)


def port_apply(name, v, dtype, x=X):
    pm = build_model(name, num_classes=C, dtype=dtype, device="cpu")
    load_flax_variables(pm, v)
    with torch.no_grad():
        f, lg = pm(torch.from_numpy(x).to(dtype))
    assert f.dtype == lg.dtype == dtype
    return f.float().numpy(), lg.float().numpy()


@pytest.mark.parametrize("name,renorm", [("cares18", False),
                                         ("emares18", False),
                                         ("seres18", True)])
def test_bridge_tree_equals_flax_init(name, renorm):
    """Shapes and dtypes (BatchRenorm's int32 `steps` among them), and the
    way back (`torch_state_dict`) exact."""
    jm = jbuild(name, num_classes=C, renorm=renorm) if renorm else jbuild(
        name, num_classes=C)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)), train=False))
    v = port_variables(name, C, renorm)
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), s.dtype.name),
                                  shapes)
    got = jax.tree_util.tree_map(lambda a: (np.shape(a), a.dtype.name), v)
    assert got == want
    pm = build_model(name, num_classes=C, device="cpu", renorm=renorm)
    load_flax_variables(pm, v)
    sd = torch_state_dict(flax_variables(pm))
    for k, t in pm.state_dict().items():
        assert sd[k].dtype == t.dtype and torch.equal(sd[k], t), k


@pytest.fixture(scope="module")
def f32_outputs(variables):
    return {n: flax_apply(n, variables[n], jnp.float32) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_eval_f32_matches_flax(variables, f32_outputs, name):
    got = port_apply(name, variables[name], torch.float32)
    assert got[0].shape == (2, 512) and got[1].shape == (2, C)
    for g, w in zip(got, f32_outputs[name]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def cosine_rows(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("name", NAMES)
def test_eval_bf16_matches_flax(variables, f32_outputs, name):
    want = flax_apply(name, variables[name], jnp.bfloat16)
    got = port_apply(name, variables[name], torch.bfloat16)
    for g, w, ref in zip(got, want, f32_outputs[name]):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        assert cosine_rows(g, w).min() >= 0.99998
        assert np.linalg.norm(g - ref) <= 1.25 * np.linalg.norm(w - ref)


# emares18's int8 output against JAX's, a cosine a row. Every int8 layer
# agrees bit for bit on JAX's own input, but EMA's f32 reductions, softmax
# and sigmoids sum and round in another order than XLA's; where that moves
# a bf16 rounding of a block's output, the next int8 layer's input moves
# by one quantization step (read: 1 / 0.99997 feature, 1 / 0.99984
# logits, per image)
COS_INT8_EMA = 0.9995


def record_quantized_layers(monkeypatch):
    """Each int8 layer's input and output inside the jitted JAX program,
    by path (read back through `jax.debug.callback`)."""
    records = {}

    def recorded(fn):
        def layer(m, x, kq, sw, sx):
            out = fn(m, x, kq, sw, sx)
            path = jqz._path_str(m)
            jax.debug.callback(lambda a, b: records.setdefault(path, (
                np.asarray(a, np.float32), np.asarray(b, np.float32),
                a.dtype.name)), x, out)
            return out
        return layer
    monkeypatch.setattr(jqz, "_quantized_conv", recorded(jqz._quantized_conv))
    monkeypatch.setattr(jqz, "_quantized_dense",
                        recorded(jqz._quantized_dense))
    return records


@pytest.mark.parametrize("name", NAMES)
def test_int8_equals_jax_quantized_apply(variables, name, monkeypatch):
    x = X[:, :64, :32]
    v = variables[name]
    jm = jbuild(name, num_classes=C, dtype=jnp.bfloat16)
    calls = force_jax_routes(monkeypatch)
    qs = jqz.quantize(jm, v, [jnp.asarray(x)], train=False)
    records = record_quantized_layers(monkeypatch)
    fj, lj = jax.jit(lambda vv, xx: jqz.quantized_apply(
        jm, vv, qs, xx.astype(jnp.bfloat16), train=False))(v, jnp.asarray(x))
    jax.effects_barrier()
    assert calls == {"qconv": len(K1_SITES), "qblock": 0}

    pm = build_model(name, num_classes=C, dtype=torch.bfloat16, device="cpu")
    load_flax_variables(pm, v)
    qm = tqz.quantized_model(pm, quant_state_from_flax(qs, "cpu"))
    convs = dict(tqz.quantizable(pm))
    assert set(convs) == set(qs.kernels) == set(records)
    routed = sorted(p for p in convs if getattr(
        qm.get_submodule(p.replace("/", ".")), "route", False))
    assert routed == sorted(K1_SITES)
    assert not any(isinstance(m, tqz.QSEBasicBlock) for m in qm.modules())
    # every int8 layer on JAX's own input: the same integer accumulator,
    # scaled and rounded alike
    with torch.no_grad():
        for path, (xin, out, dtype) in records.items():
            layer = qm.get_submodule(path.replace("/", "."))
            got = layer(torch.from_numpy(xin).to(getattr(torch, dtype)))
            np.testing.assert_array_equal(got.float().numpy(), out,
                                          err_msg=path)
        ft, lt = qm(torch.from_numpy(x).to(torch.bfloat16))
    for got, want in ((ft, fj), (lt, lj)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if name == "cares18":
            np.testing.assert_array_equal(got, want)
        else:
            assert cosine_rows(got, want).min() >= COS_INT8_EMA


@pytest.mark.parametrize("name,renorm,fused", [
    ("seres18", False, 4), ("seres18", True, 0), ("cares18", False, 0),
    ("emares18", False, 0)])
def test_quantized_model_fuses_only_se_batch_norm_blocks(name, renorm,
                                                         fused):
    """Every conv and dense layer quantized (unit activation scales: the
    routing reads which layers are quantized, not their scales)."""
    model = build_model(name, num_classes=C, dtype=torch.bfloat16,
                        device="cpu", renorm=renorm)
    qs = tqz.quantize_weights(model, {p: 1.0 for p, _ in
                                      tqz.quantizable(model)})
    qm = tqz.quantized_model(model, qs)
    blocks = [m for m in qm.modules() if isinstance(m, tqz.QSEBasicBlock)]
    assert len(blocks) == fused
    routed = [m for m in qm.modules() if getattr(m, "route", False)]
    assert len(routed) == (2 if fused else len(K1_SITES))
