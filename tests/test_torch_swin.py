"""Swin-T v1 / v2 with the U-Net head (`swin_v1`, `swin_v2`) in the port
against the JAX package's flax module, at a reduced size (hidden 16,
layers (2, 2, 2, 2), heads (1, 2, 2, 4), head_dim 8, window 2 at 64x64, as
tests/test_models_transformers.py builds it), and the full-width tree.

Weights are the port's random init (a generator seeded 0) with random
running statistics and biases (test_torch_attention.randomize), carried
to JAX as flax variables; each tree equals the flax init's
(`jax.eval_shape`), with and without the SIE table (flax creates it only
where `init` saw a cam), and at full width, where Swin-T has 40,628,113
parameters at 448x224 with 751 classes.

  * Each block bit-equal in bf16 to the jitted flax block:
    `WindowAttention` v1 and v2, shifted and not (rounded: v2's regular
    block hands post_proj's biased sum to its post-norm in f32),
    `SwinBlock` v1 and v2, shifted and not, and `PatchMerging`; in f32
    within 1e-5 of the largest magnitude.
  * The model in eval mode: f32 within rtol = atol = 1e-4; bf16 within
    2^-6 of the largest magnitude of flax's bf16 output, a cosine a row
    >= 0.99998 and an L2 distance from flax's f32 output at most 1.25x
    flax's own bf16 program's (ROADMAP C's whole-model limits).
  * int8 against `quantized_apply` with one QuantState: the quantized
    layers are exactly JAX's QuantState's keys (the stem's convs and fc,
    to_qkv, to_out, post_proj, fc1, fc2, the mergers, v2's meta-MLP on its
    constant, img_channel_align, mlp_head; not the transposed convs or
    the norms), every call's int8 input and s32 accumulator replay
    exactly, and from them the same output bit for bit but in v2's f32
    meta_fc1, within an f32 ulp of the larger of the product and the sum:
    its int8 input is a constant, so XLA
    folds acc * scale at compile time and adds the bias apart (two
    roundings), where everywhere else it contracts the two into one FMA
    (one, `quantize.scale_add`). The embed within a cosine of 0.999 a
    row, and neither K1 nor the fused block is taken.
  * A 224x112 input raises in both packages (the grid does not halve
    three times into whole 7x7 windows).
  * The f32 and int8 `.pt2` artifacts of `swin_v1` serve as the model
    does in process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.utils.quantize as jqz
from reid_tpu.models import build_model as jbuild
from reid_tpu.models import swin as js
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models import swin as ts
from reid_tpu_torch.utils import quantize as tqz
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              quant_state_from_flax)
from test_torch_attention import close, flax_eval, flax_init, port_eval
from test_torch_attention import randomize
from test_torch_cares import cosine_rows
from test_torch_osnet import record_accumulators
from test_torch_quantize import force_jax_routes
from test_torch_train_data import two_torch_threads  # noqa: F401
from test_torch_vit import tree_shapes

NAMES = ["swin_v1", "swin_v2"]
C = 8
HW = (64, 64)
KW = dict(hidden_dim=16, layers=(2, 2, 2, 2), heads=(1, 2, 2, 4),
          head_dim=8, window_size=2)
X = np.random.default_rng(0).normal(size=(2, *HW, 3)).astype(np.float32)


def port_variables(name, seed=1, **kw):
    model = build_model(name, num_classes=C, device="cpu", **dict(KW, **kw))
    return randomize(flax_variables(model), seed)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("sie", [False, True])
def test_bridge_tree_equals_flax_init(name, sie):
    """The tree with the SIE table where flax's `init` saw a cam and
    without it where it did not; a model built either way loads either
    tree (the table follows the tree), and the way back is exact."""
    jm = jbuild(name, num_classes=C, **KW)
    cam = jnp.zeros((2,), jnp.int32) if sie else None
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, *HW, 3)), cam=cam,
        train=False))
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), s.dtype.name),
                                  shapes)
    v = port_variables(name, sie=sie)
    assert tree_shapes(v) == want
    assert ("side_info_embedding" in v["params"]) == sie
    for built in (False, True):
        pm = build_model(name, num_classes=C, device="cpu", sie=built, **KW)
        load_flax_variables(pm, v)
        assert (pm.side_info_embedding is not None) == sie
        back = build_model(name, num_classes=C, device="cpu", **KW)
        load_flax_variables(back, flax_variables(pm))
        for k, t in pm.state_dict().items():
            assert torch.equal(back.state_dict()[k], t), k


def test_full_width_parameter_count():
    """Swin-T v1 at 448x224 with 751 classes (the v2 position bias is a
    meta-MLP instead of a table)."""
    jm = jbuild("swin_v1", num_classes=751)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 448, 224, 3)), train=False))
    pm = build_model("swin_v1", num_classes=751, device="cpu")
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), s.dtype.name),
                                  shapes)
    assert tree_shapes(flax_variables(pm)) == want
    assert sum(p.numel() for p in pm.parameters()) == 40_628_113
    assert sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(
        shapes["params"])) == 40_628_113


def test_cam_needs_the_sie_table():
    """Built without the table (the default, as flax's init without a
    cam), the model refuses a cam as the flax model does; built with it,
    a cam moves the embedding."""
    x = torch.from_numpy(X[:1])
    cam = torch.tensor([3])
    pm = build_model("swin_v1", num_classes=C, device="cpu", **KW)
    with pytest.raises(ValueError, match="SIE"):
        with torch.no_grad():
            pm(x, cam)
    pm = build_model("swin_v1", num_classes=C, device="cpu", sie=True, **KW)
    with torch.no_grad():
        assert not torch.equal(pm(x, cam)[0], pm(x)[0])


def _attention(version, shifted):
    return (lambda dt: js.WindowAttention(16, 2, 8, shifted, 2, version,
                                          dtype=dt),
            lambda dt: ts.WindowAttention(16, 2, 8, shifted, 2, version, dt),
            16)


def _block(version, shifted):
    return (lambda dt: js.SwinBlock(16, 2, 8, shifted, 2, version, dtype=dt),
            lambda dt: ts.SwinBlock(16, 2, 8, shifted, 2, version, dt), 16)


# (flax module at a dtype, port module at a dtype, input channels)
BLOCKS = {f"{kind}_{v}{'_shift' if s else ''}": make(v, s)
          for kind, make in (("attention", _attention), ("block", _block))
          for v in ("v1", "v2") for s in (False, True)}
BLOCKS["patch_merging"] = (lambda dt: js.PatchMerging(32, 2, dtype=dt),
                           lambda dt: ts.PatchMerging(16, 32, 2, dt), 16)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_bf16_bit_equal_flax(block):
    jmake, tmake, cin = BLOCKS[block]
    x = np.random.default_rng(0).normal(size=(2, 8, 8, cin)).astype(
        np.float32)
    kw = {} if block == "patch_merging" else dict(train=False)
    v = flax_init(jmake(jnp.float32), x, **kw)
    want = flax_eval(jmake(jnp.bfloat16), v, x, jnp.bfloat16, **kw)
    pm = tmake(torch.bfloat16)
    load_flax_variables(pm, v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(torch.bfloat16)).to(torch.bfloat16)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got.float().numpy(), want)
    want = flax_eval(jmake(jnp.float32), v, x, jnp.float32, **kw)
    close(port_eval(tmake(torch.float32), v, x, torch.float32), want, 1e-5)


@pytest.fixture(scope="module")
def variables():
    return {n: port_variables(n) for n in NAMES}


def flax_apply(name, v, dtype, x=X):
    jm = jbuild(name, num_classes=C, dtype=dtype, **KW)
    out = jax.jit(lambda vv, xx: jm.apply(vv, xx.astype(dtype),
                                          train=False))(v, jnp.asarray(x))
    return [np.asarray(o, np.float32) for o in out]


def port_apply(name, v, dtype, x=X):
    pm = build_model(name, num_classes=C, dtype=dtype, device="cpu", **KW)
    load_flax_variables(pm, v)
    with torch.no_grad():
        out = pm(torch.from_numpy(x).to(dtype))
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("name", NAMES)
def test_eval_matches_flax(variables, name):
    v = variables[name]
    ref = flax_apply(name, v, jnp.float32)
    got = port_apply(name, v, torch.float32)
    assert [g.shape for g in got] == [(2, 16), (2, C)]
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    want = flax_apply(name, v, jnp.bfloat16)
    got = port_apply(name, v, torch.bfloat16)
    for g, w, r in zip(got, want, ref):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        assert cosine_rows(g, w).min() >= 0.99998
        assert np.linalg.norm(g - r) <= 1.25 * np.linalg.norm(w - r)


@pytest.mark.parametrize("name", NAMES)
def test_int8_swin_equals_jax_quantized_apply(variables, name, monkeypatch):
    v = variables[name]
    jm = jbuild(name, num_classes=C, dtype=jnp.bfloat16, **KW)
    calls = force_jax_routes(monkeypatch)
    qs = jqz.quantize(jm, v, [jnp.asarray(X)], train=False)
    records = record_accumulators(monkeypatch)
    fj, lj = jax.jit(lambda vv, xx: jqz.quantized_apply(
        jm, vv, qs, xx.astype(jnp.bfloat16), train=False))(v, jnp.asarray(X))
    jax.effects_barrier()
    assert calls == {"qconv": 0, "qblock": 0}
    pm = build_model(name, num_classes=C, dtype=torch.bfloat16,
                     device="cpu", **KW)
    load_flax_variables(pm, v)
    qm = tqz.quantized_model(pm, quant_state_from_flax(qs, "cpu"))
    layers = dict(tqz.quantizable(pm))
    assert set(layers) == set(qs.kernels) == set(records)
    leaves = {p.rsplit("/", 1)[-1] for p in layers}
    assert leaves == {"sfe_conv1", "sfe_conv2", "sfe_fc", "to_qkv", "to_out",
                      "post_proj", "fc1", "fc2", "linear",
                      "img_channel_align", "mlp_head"} | (
        {"meta_fc1", "meta_fc2"} if name == "swin_v2" else set())
    assert len(layers) == 3 + 8 * 5 + 3 + 2 + (16 if name == "swin_v2"
                                               else 0)
    assert not any(getattr(m, "route", False) for m in qm.modules())
    with torch.no_grad():
        for path, rec in records.items():
            layer = qm.get_submodule(path.replace("/", "."))
            assert len(rec["xq_acc"]) == len(rec["out"]) == 1, path
            for (xq, acc), (out, dtype) in zip(rec["xq_acc"], rec["out"]):
                got = layer.acc(torch.from_numpy(np.array(xq)))
                np.testing.assert_array_equal(got.numpy(), acc.astype(
                    np.float32), err_msg=path)
                got = tqz.scale_add(got, layer.scale, layer.bias).to(
                    getattr(torch, dtype)).float().numpy()
                if path.endswith("meta_fc1"):
                    # one rounding of the product apart: an ulp of the
                    # larger of the product and the sum
                    prod = np.abs(acc.astype(np.float32)
                                  * layer.scale.numpy())
                    assert np.all(np.abs(got - out) <= np.spacing(
                        np.maximum(prod, np.abs(out)))), path
                else:
                    np.testing.assert_array_equal(got, out, err_msg=path)
        ft, lt = qm(torch.from_numpy(X).to(torch.bfloat16))
    emb = lambda f, lg: np.concatenate([f, lg], 1)   # noqa: E731
    assert cosine_rows(emb(ft.float().numpy(), 100 * lt.float().numpy()),
                       emb(np.asarray(fj, np.float32),
                           100 * np.asarray(lj, np.float32))).min() >= 0.999


def test_grid_that_does_not_halve_into_windows_raises():
    """224x112 at window 7 (the example the JAX package's --crop_hw help
    gives; the reduced widths, Swin-T's window): both packages fail in the
    stages' reshape."""
    kw = dict(KW, window_size=7)
    jm = jbuild("swin_v1", num_classes=C, **kw)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 224, 112, 3)),
                                       train=False))
    pm = build_model("swin_v1", num_classes=C, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="shape"):
        with torch.no_grad():
            pm(torch.zeros((1, 224, 112, 3)))


@pytest.mark.parametrize("int8", [False, True])
def test_artifact_serves_as_in_process(variables, tmp_path, int8):
    """`export_reid_artifact` of `swin_v1` (f32, and int8 from one
    calibration): the loaded artifact equals serving the model in process
    bit for bit at two batch sizes, with neither K1 nor the fused block in
    the graph."""
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             export_reid_artifact,
                                             load_serving_fn, make_embed_fn,
                                             make_int8_embed_fn)
    pm = build_model("swin_v1", num_classes=C, device="cpu", **KW)
    load_flax_variables(pm, variables["swin_v1"])
    gen = torch.Generator().manual_seed(0)
    qstate = calibrate_serving_qstate(
        pm, torch.rand((4, *HW, 3), generator=gen) * 255) if int8 else None
    path = str(tmp_path / "swin.pt2")
    ep = export_reid_artifact(pm, path, *HW, qstate=qstate)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert not any("conv3x3_s8" in t or "se_basic_block_s8" in t
                   for t in targets)
    serve = make_int8_embed_fn(pm, qstate=qstate) if int8 else \
        make_embed_fn(pm)
    fn = load_serving_fn(path)
    for b in (1, 3):
        x = torch.rand((b, *HW, 3), generator=gen) * 255
        with torch.no_grad():
            want = serve(x)
            got = fn(x)
        assert got.shape == (b, 16 + C)
        assert torch.equal(got, want)
