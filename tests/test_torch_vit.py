"""ViT-t with SIE (`vit`) in the port against the JAX package's flax
module, at a reduced size (dim 64, depth 2, 4 heads, mlp 128 at 128x64:
8 tokens + cls), with one full-head-width block (dim 384, 16 heads of 24),
and the full-width tree.

Weights are the port's random init (a generator seeded 0) with random
running statistics and biases (test_torch_attention.randomize), carried
to JAX as flax variables; each tree equals the flax init's
(`jax.eval_shape`, so no init is compiled), at full width too, where the
model has 19,714,752 parameters at 448x224 with 751 classes.

  * Each block in bf16 against the jitted flax block: the
    `TransformerBlock` (flax's `MultiHeadDotProductAttention` written
    out, the tanh gelu) bit for bit, at the reduced and at the full head
    width; the `ConvStem` at 64x32 bit-equal on 99% of its outputs and
    the rest one bf16 ulp away (read: 1 of 256): its InstanceNorms sum
    512 pixels a channel, XLA sequentially and torch in another order,
    and an ulp of the mean moves a rounding now and then. In f32 within
    1e-5 of the largest magnitude.
  * The model in eval mode: f32 within rtol = atol = 1e-4; bf16 within
    2^-6 of the largest magnitude of flax's bf16 output, an L2 distance
    from flax's f32 output at most 1.25x flax's own bf16 program's, and a
    cosine a row of at least `COS_BF16`. That is looser than ROADMAP C's
    0.99998: the stem's InstanceNorm sums 2,048 pixels a channel at
    128x64 in another order than XLA's, a few outputs in 10^5 land on the
    other side of a bf16 rounding, and six attention blocks carry that
    apart (read 1 - 1.1e-5 and 1 - 2.1e-5 over two seeds; at 64x32 the
    same model is bit-equal for one of them).
  * The SIE table: added x1.5 with a cam, and a view index past the table
    clamped to its last row as JAX's gather clamps it.
  * int8 at 128x64 against `quantized_apply` with one QuantState: the
    quantized layers are exactly the ones JAX's interceptor takes (the
    stem's convs and projection, fc1, fc2, mlp_head; not the attention's
    DenseGenerals), every call's int8 input and s32 accumulator replay
    exactly, the embed within a cosine of 0.999 a row, and neither K1 nor
    the fused block is taken (the stem is 64 wide).
  * The f32 and int8 `.pt2` artifacts serve as the model does in process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.utils.quantize as jqz
from reid_tpu.models import build_model as jbuild
from reid_tpu.models import vit as jv
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models import vit as tv
from reid_tpu_torch.utils import quantize as tqz
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              quant_state_from_flax,
                                              torch_state_dict)
from test_torch_attention import close, flax_eval, flax_init, port_eval
from test_torch_attention import randomize
from test_torch_cares import cosine_rows
from test_torch_osnet import record_accumulators
from test_torch_quantize import force_jax_routes
from test_torch_train_data import two_torch_threads  # noqa: F401

C = 8
HW = (128, 64)
KW = dict(dim=64, depth=2, heads=4, mlp_dim=128)
X = np.random.default_rng(0).normal(size=(2, *HW, 3)).astype(np.float32)
COS_BF16 = 0.99995


def port_variables(seed=1, **kw):
    model = build_model("vit", num_classes=C, device="cpu", input_hw=HW,
                        **dict(KW, **kw))
    return randomize(flax_variables(model), seed)


def tree_shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(np.shape(a)),
                                             np.asarray(a).dtype.name), tree)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_bridge_tree_equals_flax_init(full):
    """The tree (the attention's (in, heads, head_dim) and (heads,
    head_dim, out) kernels, the (heads, head_dim) biases, the cls token,
    the position table of L + 1 rows, the SIE table) and the way back
    exact; at full width the parameter count."""
    kw, hw, n = ({}, (448, 224), 751) if full else (KW, HW, C)
    jm = jbuild("vit", num_classes=n, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, *hw, 3)), train=False))
    pm = build_model("vit", num_classes=n, device="cpu", input_hw=hw, **kw)
    v = flax_variables(pm)
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), s.dtype.name),
                                  shapes)
    assert tree_shapes(v) == want
    attn = v["params"]["block0"]["attn"]
    heads, hd = (16, 24) if full else (4, 16)
    width = heads * hd
    assert attn["query"]["kernel"].shape == (width, heads, hd)
    assert attn["query"]["bias"].shape == (heads, hd)
    assert attn["out"]["kernel"].shape == (heads, hd, width)
    assert v["params"]["side_info_embedding"].shape == (6, 1, width)
    sd = torch_state_dict(v)
    for k, t in pm.state_dict().items():
        assert torch.equal(sd[k], t), k
    if full:
        assert sum(p.numel() for p in pm.parameters()) == 19_714_752
        assert sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(
            shapes["params"])) == 19_714_752


def test_head_kernels_map_explicitly():
    """A (in, heads, head_dim) kernel lands as the (heads * head_dim, in)
    weight that computes flax's product (a transpose would scramble it),
    and comes back unchanged."""
    attn = tv.MultiHeadAttention(6, 2)
    rng = np.random.default_rng(0)
    params = {n: {"kernel": rng.normal(size=(6, 2, 3)).astype(np.float32),
                  "bias": rng.normal(size=(2, 3)).astype(np.float32)}
              for n in ("query", "key", "value")}
    params["out"] = {"kernel": rng.normal(size=(2, 3, 6)).astype(np.float32),
                     "bias": rng.normal(size=(6,)).astype(np.float32)}
    load_flax_variables(attn, {"params": params})
    x = rng.normal(size=(4, 6)).astype(np.float32)
    y = rng.normal(size=(4, 2, 3)).astype(np.float32)
    q, o = params["query"], params["out"]
    with torch.no_grad():
        got_q = attn.query(torch.from_numpy(x)).numpy()
        got_o = attn.out(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got_q, np.einsum("bi,ihd->bhd", x, q["kernel"])
                               + q["bias"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_o, np.einsum("bhd,hdo->bo", y, o["kernel"])
                               + o["bias"], rtol=1e-5, atol=1e-5)
    back = flax_variables(attn)["params"]
    for n in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[n][leaf], params[n][leaf])


# (flax module at a dtype, port module at a dtype, input shape, whether
# the call takes `train`)
BLOCKS = {
    "block": (lambda dt: jv.TransformerBlock(64, 4, 128, 0.0, dtype=dt),
              lambda dt: tv.TransformerBlock(64, 4, 128, 0.0, dt),
              (2, 9, 64)),
    "block_full_heads": (
        lambda dt: jv.TransformerBlock(384, 16, 256, 0.0, dtype=dt),
        lambda dt: tv.TransformerBlock(384, 16, 256, 0.0, dt), (2, 9, 384)),
    "conv_stem": (lambda dt: jv.ConvStem(embed_dim=64, dtype=dt),
                  lambda dt: tv.ConvStem(embed_dim=64, dtype=dt),
                  (2, 64, 32, 3)),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_bf16_bit_equal_flax(block):
    """bf16 bit for bit (the block returns its residual sum in f32 for the
    next norm; rounded, it is flax's output), the stem as the module says;
    f32 within 1e-5."""
    jmake, tmake, shape = BLOCKS[block]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    v = flax_init(jmake(jnp.float32), x, train=False)
    want = flax_eval(jmake(jnp.bfloat16), v, x, jnp.bfloat16, train=False)
    pm = tmake(torch.bfloat16)
    load_flax_variables(pm, v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(torch.bfloat16)).to(torch.bfloat16)
    assert np.abs(want).max() > 0.1
    got = got.float().numpy()
    if block == "conv_stem":
        assert (got != want).mean() <= 0.01
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
    else:
        np.testing.assert_array_equal(got, want)
    want = flax_eval(jmake(jnp.float32), v, x, jnp.float32, train=False)
    close(port_eval(tmake(torch.float32), v, x, torch.float32), want, 1e-5)


@pytest.fixture(scope="module")
def variables():
    return port_variables()


def flax_apply(v, dtype, x=X, cam=None, **kw):
    jm = jbuild("vit", num_classes=C, dtype=dtype, **dict(KW, **kw))
    out = jax.jit(lambda vv, xx, cc: jm.apply(vv, xx.astype(dtype), cam=cc,
                                              train=False))(
        v, jnp.asarray(x), None if cam is None else jnp.asarray(cam))
    return [np.asarray(o, np.float32) for o in out]


def port_apply(v, dtype, x=X, cam=None, **kw):
    pm = build_model("vit", num_classes=C, dtype=dtype, device="cpu",
                     input_hw=HW, **dict(KW, **kw))
    load_flax_variables(pm, v)
    with torch.no_grad():
        out = pm(torch.from_numpy(x).to(dtype),
                 None if cam is None else torch.as_tensor(cam))
    return [o.float().numpy() for o in out]


def test_eval_matches_flax(variables):
    ref = flax_apply(variables, jnp.float32)
    got = port_apply(variables, torch.float32)
    assert [g.shape for g in got] == [(2, 64), (2, C)]
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    want = flax_apply(variables, jnp.bfloat16)
    got = port_apply(variables, torch.bfloat16)
    for g, w, r in zip(got, want, ref):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        assert cosine_rows(g, w).min() >= COS_BF16
        assert np.linalg.norm(g - r) <= 1.25 * np.linalg.norm(w - r)


def test_side_info_embedding_and_clamped_view(variables):
    """A cam adds 1.5x its SIE row (f32, 1e-4); views 6 and 40 of a
    6-row table read its last row, as JAX's clamped gather does."""
    cam = np.asarray([1, 4], np.int32)
    want = flax_apply(variables, jnp.float32, cam=cam)
    got = port_apply(variables, torch.float32, cam=cam)
    bare = port_apply(variables, torch.float32)
    assert np.abs(got[0] - bare[0]).max() > 1e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    past = np.asarray([6, 40], np.int32)
    want = flax_apply(variables, jnp.float32, cam=past)
    got = port_apply(variables, torch.float32, cam=past)
    last = port_apply(variables, torch.float32, cam=np.asarray([5, 5]))
    for g, w, t in zip(got, want, last):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g, t)


def test_position_table_fixes_the_input_size(variables):
    pm = build_model("vit", num_classes=C, device="cpu", input_hw=HW, **KW)
    with pytest.raises(ValueError, match="input_hw"):
        with torch.no_grad():
            pm(torch.zeros((1, 256, 128, 3)))


def test_int8_vit_equals_jax_quantized_apply(variables, monkeypatch):
    v = variables
    jm = jbuild("vit", num_classes=C, dtype=jnp.bfloat16, **KW)
    calls = force_jax_routes(monkeypatch)
    qs = jqz.quantize(jm, v, [jnp.asarray(X)], train=False)
    records = record_accumulators(monkeypatch)
    fj, lj = jax.jit(lambda vv, xx: jqz.quantized_apply(
        jm, vv, qs, xx.astype(jnp.bfloat16), train=False))(v, jnp.asarray(X))
    jax.effects_barrier()
    assert calls == {"qconv": 0, "qblock": 0}
    pm = build_model("vit", num_classes=C, dtype=torch.bfloat16,
                     device="cpu", input_hw=HW, **KW)
    load_flax_variables(pm, v)
    qm = tqz.quantized_model(pm, quant_state_from_flax(qs, "cpu"))
    layers = dict(tqz.quantizable(pm))
    assert set(layers) == set(qs.kernels) == set(records)
    assert set(layers) == {"stem/conv1", "stem/conv2", "stem/conv3",
                           "stem/proj", "mlp_head"} | {
        f"block{i}/{fc}" for i in range(2) for fc in ("fc1", "fc2")}
    assert not any(getattr(m, "route", False) for m in qm.modules())
    assert not any(isinstance(m, tqz.QSEBasicBlock) for m in qm.modules())
    with torch.no_grad():
        for path, rec in records.items():
            layer = qm.get_submodule(path.replace("/", "."))
            assert len(rec["xq_acc"]) == len(rec["out"]) == 1, path
            for (xq, acc), (out, dtype) in zip(rec["xq_acc"], rec["out"]):
                got = layer.acc(torch.from_numpy(np.array(xq)))
                np.testing.assert_array_equal(got.numpy(), acc.astype(
                    np.float32), err_msg=path)
                got = tqz.scale_add(got, layer.scale, layer.bias).to(
                    getattr(torch, dtype))
                np.testing.assert_array_equal(got.float().numpy(), out,
                                              err_msg=path)
        ft, lt = qm(torch.from_numpy(X).to(torch.bfloat16))
    emb = lambda f, lg: np.concatenate([f, lg], 1)   # noqa: E731
    assert cosine_rows(emb(ft.float().numpy(), 100 * lt.float().numpy()),
                       emb(np.asarray(fj, np.float32),
                           100 * np.asarray(lj, np.float32))).min() >= 0.999


@pytest.mark.parametrize("int8", [False, True])
def test_artifact_serves_as_in_process(variables, tmp_path, int8):
    """`export_reid_artifact` of `vit` (f32, and int8 from one
    calibration): the loaded artifact equals serving the model in process
    bit for bit at two batch sizes, with neither K1 nor the fused block in
    the graph."""
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             export_reid_artifact,
                                             load_serving_fn, make_embed_fn,
                                             make_int8_embed_fn)
    pm = build_model("vit", num_classes=C, device="cpu", input_hw=HW, **KW)
    load_flax_variables(pm, variables)
    gen = torch.Generator().manual_seed(0)
    qstate = calibrate_serving_qstate(
        pm, torch.rand((4, *HW, 3), generator=gen) * 255) if int8 else None
    path = str(tmp_path / "vit.pt2")
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
        assert got.shape == (b, 64 + C)
        assert torch.equal(got, want)


def test_cli_sizes_and_embeds(monkeypatch):
    """The CLIs' input sizes (`reid_tpu/cli.py:_base_cfg`: 448x224 for
    the transformers on Market and Duke, 224x224 on VeRi, 256x128 for
    the CNNs), and the track CLI's embed of each transformer at a crop
    size it takes, at full width: ViT's position table follows the crop,
    the width is feat || logits, and slices of the crops
    (`TRANSFORMER_EMBED_SLICE`) give the whole batch's embedding within
    a cosine of 0.9999 a row."""
    import argparse

    from reid_tpu_torch import cli

    def hw(backbone, dataset):
        return cli._input_hw(argparse.Namespace(
            backbone=backbone, dataset=dataset, height=0, width=0))
    assert hw("vit", "market1501") == hw("swin_v2", "dukemtmc") == (448, 224)
    assert hw("swin_v1", "veri") == (224, 224)
    assert hw("seres18", "market1501") == (256, 128)
    x = torch.rand((3, 256, 128, 3)) * 4 - 2
    with torch.no_grad():
        fn, model = cli.build_embed("vit", 10, (256, 128), "cpu")
        assert model.pos_embedding.shape == (1, 8 * 4 + 1, 384)
        emb = fn(x)
        assert emb.shape == (3, 384 + 10) and torch.isfinite(emb).all()
        monkeypatch.setattr(cli, "TRANSFORMER_EMBED_SLICE", 2)
        # another batch size may take another GEMM blocking on the CPU:
        # a bf16 rounding apart here and there (read 8e-4 of a unit row)
        cos = torch.nn.functional.cosine_similarity(fn(x), emb, dim=1)
        assert cos.min() >= 0.9999, cos
        fn, _ = cli.build_embed("swin_v1", 10, (224, 224), "cpu")
        emb = fn(torch.rand((1, 224, 224, 3)))
        assert emb.shape == (1, 96 + 10) and torch.isfinite(emb).all()
