"""int8 quantization of the port against `reid_tpu.utils.quantize`.

- Weight quantization equals the JAX package's bit for bit (int8 kernels,
  per-channel scales, activation scales from the same absmax).
- Calibration absmax agrees per layer to 1e-2 relative (each side runs its
  own bf16 forward).
- The int8 embed, given the SAME QuantState carried across from JAX, runs
  the port (plain kernel versions, both routes on) against JAX
  `quantized_apply` with its routes forced on through the JAX package's
  own plain references (set up with monkeypatch; nothing in the package is
  edited). The L2-normalized [feat || logits] reach cosine >= 0.999 on
  every row. The minimum measured when this test was written is 0.9999999:
  the two embeds were equal bit for bit, once the port quantized inputs by
  the f32 reciprocal of the scale (as XLA compiles `x / sx`) and rounded
  each step of the bf16 SE sigmoid (as XLA expands `jax.nn.sigmoid`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.ops.qblock as jqb
import reid_tpu.ops.qconv as jqc
import reid_tpu.utils.quantize as jqz
from reid_tpu.models import build_model as jbuild
from reid_tpu_torch.models import build_model
from reid_tpu_torch.utils import quantize as tqz
from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                              quant_state_from_flax)


def force_jax_routes(monkeypatch):
    """Route the JAX package's int8 path through both kernels, computed by
    their own references (as the package's CPU tests run them)."""
    calls = {"qconv": 0, "qblock": 0}

    def conv(x, wq, scale, img_block=0, out_dtype=jnp.bfloat16,
             interpret=False):
        calls["qconv"] += 1
        return jqc.conv3x3_s8_reference(x, wq, scale, out_dtype=out_dtype)

    def block(x, p, img_block=0, out_dtype=jnp.bfloat16, ibn=False,
              interpret=False):
        calls["qblock"] += 1
        return jqb.qblock_reference(x, p, ibn=ibn).astype(out_dtype)

    monkeypatch.setattr(jqz, "_on_tpu", lambda: True)
    monkeypatch.setattr(jqz, "USE_PALLAS_QCONV", True)
    monkeypatch.setattr(jqz, "USE_PALLAS_QBLOCK", True)
    monkeypatch.setattr(jqc, "conv3x3_s8", conv)
    monkeypatch.setattr(jqb, "se_basic_block_s8", block)
    return calls


@pytest.fixture(scope="module")
def seres18():
    model = jbuild("seres18", num_classes=16, dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3), jnp.bfloat16))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    x = ((rng.random((8, 64, 32, 3), dtype=np.float32) - 0.45) / 0.225
         ).astype(np.float32)
    tm = build_model("seres18", num_classes=16, dtype=torch.bfloat16,
                     device="cpu")
    load_flax_variables(tm, variables)
    return model, variables, x, tm


def test_calibration_and_weights_match_jax(seres18):
    model, variables, x, tm = seres18
    jab = jqz.calibrate(model, variables, [jnp.asarray(x)], train=False)
    tab = tqz.calibrate(tm, [torch.from_numpy(x)])
    assert set(tab) == set(jab) and len(jab) == 37
    for k in jab:
        assert abs(tab[k] - jab[k]) <= 1e-2 * jab[k], (k, tab[k], jab[k])

    # from the same absmax, the quantized weights are identical
    jqs = jqz.quantize_weights(model, variables, jab)
    tqs = tqz.quantize_weights(tm, jab)
    for k in jab:
        kt = tqs.kernels[k].numpy()
        kt = kt.transpose(2, 3, 1, 0) if kt.ndim == 4 else kt.T
        np.testing.assert_array_equal(kt, np.asarray(jqs.kernels[k]))
        np.testing.assert_array_equal(tqs.w_scales[k].numpy(),
                                      np.asarray(jqs.w_scales[k]))
        assert np.float32(tqs.act_scales[k]) == np.float32(
            jqs.act_scales[k])


def test_int8_embed_matches_jax_routed(seres18, monkeypatch):
    model, variables, x, tm = seres18
    calls = force_jax_routes(monkeypatch)
    qs = jqz.quantize(model, variables, [jnp.asarray(x)], train=False)
    fj, lj = jax.jit(lambda v, xx: jqz.quantized_apply(
        model, v, qs, xx.astype(jnp.bfloat16), train=False))(
            variables, jnp.asarray(x))
    assert calls == {"qconv": 2, "qblock": 4}

    qm = tqz.quantized_model(tm, quant_state_from_flax(qs, "cpu"))
    routed = [n for n in ("block22", "block32", "block41", "block42")
              if isinstance(getattr(qm, n), tqz.QSEBasicBlock)]
    assert len(routed) == 4
    assert qm.block21.conv2.route and qm.block31.conv2.route
    assert not qm.block21.conv1.route and not qm.block11.conv1.route
    with torch.no_grad():
        ft, lt = qm(torch.from_numpy(x).to(torch.bfloat16))

    def emb(f, lg):
        e = np.concatenate([np.asarray(f, np.float32),
                            np.asarray(lg, np.float32)], 1)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    cos = np.sum(emb(fj, lj) * emb(ft.float().numpy(), lt.float().numpy()),
                 axis=1)
    assert cos.min() >= 0.999, cos


def jit_quantize(v: torch.Tensor, sx: float) -> torch.Tensor:
    """The input quantization of `_quantized_conv` / `_quantized_dense` as
    the JAX package runs it: jitted, with the scale a constant."""
    fn = jax.jit(lambda a: jnp.clip(jnp.round(a.astype(jnp.float32) / sx),
                                    -127.0, 127.0))
    return torch.from_numpy(np.array(fn(jnp.asarray(v.float().numpy()))))


def test_int8_layers_are_exact_integer_math(seres18):
    """A non-routed conv and the classifier: the port's int8 layers equal
    the same math in float64 (`_quantized_conv` / `_quantized_dense`), with
    the inputs quantized as the compiled JAX program quantizes them."""
    _, _, x, tm = seres18
    tqs = tqz.quantize(tm, [torch.from_numpy(x)])
    qm = tqz.quantized_model(tm, tqs)
    q = qm.conv0
    xin = torch.from_numpy(x).to(torch.bfloat16)
    xq = jit_quantize(xin, q.sx)
    assert torch.equal(tqz.quantize_input(xin, q.sx).float(), xq)
    acc = torch.nn.functional.conv2d(
        xq.permute(0, 3, 1, 2).double(),
        tqs.kernels["conv0"].double(), stride=2, padding=3)
    want = (acc.permute(0, 2, 3, 1).float() * q.scale).to(torch.bfloat16)
    assert torch.equal(q(xin), want)
    c = qm.classifier
    feat = torch.randn(5, 512).to(torch.bfloat16)
    fq = jit_quantize(feat, c.sx)
    want = ((fq.double() @ tqs.kernels["classifier"].double().T).float()
            * c.scale).to(torch.bfloat16)
    assert torch.equal(c(feat), want)
