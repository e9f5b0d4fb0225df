"""The transformers' train step and optimizer branch in the port against
the JAX package's `make_train_step` and `make_optimizers`, at the reduced
sizes of tests/test_torch_vit.py (ViT: dim 64, depth 2, 4 heads at
128x64) and tests/test_torch_swin.py (Swin v1: hidden 16, window 2 at
64x64), f32, 4 classes, a batch of 8 (4 ids x 2).

The JAX package's `train_main` cannot train either transformer (ViT's
384-wide feature meets loss tables sized by feat_dim = 512; Swin's step
passes cams to a model initialised without its SIE table, ROADMAP C): the
port's `train_main` refuses both, and the step is held as the library
that JAX can run, with `cfg.model.feat_dim` at the model's width, ViT
with cams (its SIE table) and Swin without.

  * The optimizer branch (ref image_reid_train.py:271-277): plain SGD
    without momentum from 0.008 under PK sampling, Adam from 0.01
    otherwise, weight decay 1e-4 into the gradient, under the global-norm
    clip: four updates equal optax's within 1e-6.
  * One step on each branch from one state (the weights the port's init
    with random running statistics and biases, carried to JAX): JAX's
    step runs with every flax `nn.Dropout` made the identity by an
    interceptor (Swin's attention dropout is a constant 0.1 in the flax
    module), and both ViTs are built with dropout 0. Every loss component
    within 1e-4 relative, but Swin's triplet (and so the total) within
    5e-4: the random-init Swin's features are nearly parallel (pairwise
    distances 0.06-0.13 at norm 3.1), so the f32 |a|^2 + |b|^2 - 2ab
    distance cancels to ~1e-4 of a distance in any summation order (the
    triplet read 0.677466 here, 0.677315 in JAX's jitted step, 0.677354
    in its eager loss on the same features, against 0.677277 exact in
    float64; the features themselves agree to 7e-8); the running
    statistics within 1e-3 of their largest magnitude; under plain SGD
    the update is linear in the gradient, so it is held to the
    gradient's limit (within 1e-3 of its norm); under Adam at a cosine
    >= 0.9995 and within 3% of its norm (Adam's steps of elements whose
    gradient is rounding noise).
  * The port's dropout: the share dropped, the 1 / (1 - rate) scale, one
    (q_len, kv_len) attention mask broadcast over batch and heads, and
    the same generator giving the same step twice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import reid_tpu.config as jcfg
import reid_tpu_torch.config as tcfg
from reid_tpu.losses import DCCState as JDCC
from reid_tpu.losses import init_hybrid_state as jinit_hybrid
from reid_tpu.models import build_model as jbuild
from reid_tpu.train.state import ReIDTrainState as JState
from reid_tpu.train.state import make_optimizers as jmake_optimizers
from reid_tpu.train.steps import make_train_step as jmake_train_step
from reid_tpu_torch.losses import DCCState, HybridLossState
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models import vit as tv
from reid_tpu_torch.models.layers import ConvTranspose2d, dropout
from reid_tpu_torch.train.state import ReIDTrainState, make_optimizers
from reid_tpu_torch.train.steps import make_train_step
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              torch_state_dict)
from test_torch_attention import randomize
from test_torch_train_data import two_torch_threads  # noqa: F401
from test_torch_train_step import _tree, close

TC, B = 4, 8
LABELS = np.asarray([0, 0, 2, 2, 1, 1, 3, 3], np.int32)
CAMS = np.asarray([0, 1, 2, 3, 4, 5, 0, 1], np.int32)
# name -> (reduced widths, input size, feature width)
MODELS = {
    "vit": (dict(dim=64, depth=2, heads=4, mlp_dim=128), (128, 64), 64),
    "swin_v1": (dict(hidden_dim=16, layers=(2, 2, 2, 2), heads=(1, 2, 2, 4),
                     head_dim=8, window_size=2), (64, 64), 16),
}


def configs(name, instances, feat_dim, hw):
    train = dict(batch_size=B, num_instances=instances, warmup_epochs=0,
                 hold_epochs=2, epochs=3)
    model = dict(backbone=name, num_classes=TC, dtype="float32",
                 feat_dim=feat_dim)
    data = dict(height=hw[0], width=hw[1])
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), **model),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(**model),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    return jc, tc


@pytest.mark.parametrize("instances", [4, 0], ids=["pk_sgd", "adam"])
def test_transformer_optimizer_matches_optax(instances):
    """Four updates with gradient norms 0.5x-40x the clip through the
    schedule's hold and cosine."""
    jc, tc = configs("swin_v2", instances, 16, (64, 64))
    tx, _ = jmake_optimizers(jc, 1)
    ptx, _ = make_optimizers(tc, 1)
    assert ptx.adam == (instances == 0) and not ptx.momentum
    assert ptx.schedule(0) == pytest.approx(0.008 if instances else 0.01)
    assert ptx.weight_decay == 1e-4
    rng = np.random.default_rng(4)
    params = _tree(rng, 1.0)
    tparams = [torch.from_numpy(p.copy())
               for p in jax.tree_util.tree_leaves(params)]
    opt, topt = tx.init(params), ptx.init(tparams)
    for scale in (0.5, 40.0, 3.0, 10.0):
        grads = _tree(rng, scale)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        ptx.apply(tparams, [torch.from_numpy(g) for g in
                            jax.tree_util.tree_leaves(grads)], topt)
        for got, want in zip(tparams, jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    assert topt["count"] == 4


def no_dropout(next_fun, args, kwargs, ctx):
    """flax interceptor: every `nn.Dropout` the identity."""
    if isinstance(ctx.module, nn.Dropout) and ctx.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def variables(name):
    kw, hw, _ = MODELS[name]
    model = build_model(name, num_classes=TC, device="cpu", input_hw=hw,
                        **kw)
    return randomize(flax_variables(model), 3)


def jax_state(name, v, jc, width=None):
    """A JAX train state from `v` with random centers and unit DCC table
    rows `width` wide (the model's by default), as `create_train_state`
    builds one (without its flax init)."""
    kw, _, feat = MODELS[name]
    width = width or feat
    extra = dict(dropout=0.0) if name == "vit" else {}
    jmodel = jbuild(name, num_classes=TC, dtype=jnp.float32, **kw, **extra)
    tx, center_tx = jmake_optimizers(jc, 1)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    ls = jinit_hybrid(jax.random.PRNGKey(1), TC, width)
    rng = np.random.default_rng(5)
    lut = rng.normal(size=(2, TC, TC)).astype(np.float32)
    lut /= np.linalg.norm(lut, axis=2, keepdims=True)
    ls = ls._replace(dcc=JDCC(jnp.asarray(lut[0]), jnp.asarray(lut[1])))
    return JState(step=jnp.zeros((), jnp.int32), params=params,
                  batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                     v["batch_stats"]),
                  opt_state=tx.init(params), loss_state=ls,
                  center_opt_state=center_tx.init(ls.centers), xbm=None,
                  apply_fn=jmodel.apply, tx=tx, center_tx=center_tx)


def port_state(name, v, js, tc):
    kw, hw, _ = MODELS[name]
    model = build_model(name, num_classes=TC, device="cpu", input_hw=hw,
                        dropout=0.0, **kw)
    load_flax_variables(model, v)
    tx, center_tx = make_optimizers(tc, 1)
    t = lambda a: torch.tensor(np.asarray(a))   # noqa: E731
    ls = HybridLossState(centers=t(js.loss_state.centers),
                         dcc=DCCState(t(js.loss_state.dcc.lut_ccc),
                                      t(js.loss_state.dcc.lut_icc)))
    return ReIDTrainState(model=model, loss_state=ls,
                          opt_state=tx.init(list(model.parameters())),
                          tx=tx, center_tx=center_tx)


@pytest.mark.parametrize("instances", [4, 0], ids=["pk_sgd", "adam"])
@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(name, instances):
    _, hw, width = MODELS[name]
    jc, tc = configs(name, instances, width, hw)
    v = variables(name)
    js = jax_state(name, v, jc)
    ts = port_state(name, v, js, tc)
    start = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    x = np.random.default_rng(10).normal(size=(B, *hw, 3)).astype(
        np.float32)
    batch = {"images": x, "labels": LABELS}
    if name == "vit":
        batch["cams"] = CAMS
    with nn.intercept_methods(no_dropout):
        js, jm = jmake_train_step(jc)(js, {k: jnp.asarray(a)
                                           for k, a in batch.items()})
    ts, tm = make_train_step(tc)(ts, {k: torch.from_numpy(a)
                                      for k, a in batch.items()})
    assert tm.keys() == jm.keys()
    for k in jm:
        rtol = 5e-4 if name == "swin_v1" and k in ("loss", "triplet") \
            else 1e-4
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    transposed = [n for n, m in ts.model.named_modules()
                  if isinstance(m, ConvTranspose2d)]
    sd = torch_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, js.params), "batch_stats": jax.tree_util.tree_map(
            np.asarray, js.batch_stats)}, transposed)
    names = [n for n, _ in ts.model.named_parameters()]
    upd_t = torch.cat([(p.detach() - start[n]).ravel()
                       for n, p in ts.model.named_parameters()]).double()
    upd_j = torch.cat([(sd[n] - start[n]).ravel() for n in names]).double()
    assert float(upd_j.norm()) > 0
    if instances:
        # -lr (clip(g) + wd p): the gradient's limit
        assert float((upd_t - upd_j).norm()) <= 1e-3 * float(upd_j.norm())
    else:
        assert float(upd_t @ upd_j / (upd_t.norm() * upd_j.norm())) >= 0.9995
        assert float((upd_t - upd_j).norm()) <= 0.03 * float(upd_j.norm())
    for bname, b in ts.model.named_buffers():
        if bname in sd:
            close(b.numpy(), sd[bname].numpy(), 1e-3)
    assert ts.step == 1


def test_dropout_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000, dtype=torch.bfloat16)
    y = dropout(x, 0.1, gen)
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.1) < 0.005
    # x / keep in the dtype, as flax's `inputs / keep_prob`
    assert torch.equal(y[kept], (x / 0.9)[kept])
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, None)


def test_attention_dropout_mask_is_broadcast_over_batch_and_heads():
    """One (q_len, kv_len) mask for every image and head, applied to the
    softmax as keep / keep_prob: the module's output equals the same
    draw applied by hand."""
    attn = tv.MultiHeadAttention(16, 4, dropout=0.5)
    for m in (attn.query, attn.key, attn.value, attn.out):
        m.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn((3, 5, 16), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = attn(x, train=True, rng=torch.Generator().manual_seed(7))
        mask = torch.rand((1, 1, 5, 5),
                          generator=torch.Generator().manual_seed(7)) < 0.5
        q = attn.query(x) * attn.inv_root
        w = tv.softmax_in_dtype(torch.einsum("bqhd,bkhd->bhqk", q,
                                             attn.key(x)))
        w = w * (mask.float() / 0.5)
        want = attn.out(torch.einsum("bhqk,bkhd->bqhd", w, attn.value(x)))
        assert 0 < mask.float().mean() < 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        evald = attn(x)
    assert not torch.equal(got, evald)


def test_same_generator_gives_the_same_step():
    """Two ViT steps with dropout 0.1 from one state and generators of one
    seed update the parameters identically; another seed does not."""
    name = "vit"
    kw, hw, width = MODELS[name]
    _, tc = configs(name, 4, width, hw)
    v = variables(name)
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(B, *hw, 3)).astype(np.float32))
    batch = {"images": x, "labels": torch.from_numpy(LABELS),
             "cams": torch.from_numpy(CAMS)}
    out = []
    for seed in (0, 0, 1):
        model = build_model(name, num_classes=TC, device="cpu",
                            input_hw=hw, **kw)
        load_flax_variables(model, v)
        tx, ctx = make_optimizers(tc, 1)
        ls = HybridLossState(
            centers=torch.zeros((TC, width)),
            dcc=DCCState(torch.eye(TC), torch.eye(TC)))
        state = ReIDTrainState(model=model, loss_state=ls,
                               opt_state=tx.init(list(model.parameters())),
                               tx=tx, center_tx=ctx)
        step = make_train_step(tc, generator=torch.Generator()
                               .manual_seed(seed))
        state, _ = step(state, batch)
        out.append(torch.cat([p.detach().ravel()
                              for p in model.parameters()]))
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], out[2])


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_train_main_path_fails_and_port_refuses(name, capsys):
    """JAX's `make_train_step` as `train_cnn` runs it (feat_dim 512, cams
    in the batch), on the state `create_train_state` makes (loss tables
    512 wide, a Swin initialised without a cam, so without its SIE
    table), fails on the first step: ViT's 64-wide (384 at full width)
    feature against the 512-wide tables, Swin's missing SIE table. The
    port's `train_main` refuses the backbone at the parser, naming that
    fault."""
    from reid_tpu_torch import cli
    kw, hw, _ = MODELS[name]
    jc, _ = configs(name, 4, 512, hw)
    state = jax_state(name, variables(name), jc, width=512)
    batch = {"images": jnp.zeros((B, *hw, 3)),
             "labels": jnp.asarray(LABELS), "cams": jnp.asarray(CAMS)}
    with pytest.raises(Exception) as info:
        jmake_train_step(jc)(state, batch)
    text = str(info.value)
    if name == "vit":
        assert "dot_general" in text and "512" in text
    else:
        assert "side_info_embedding" in text
    with pytest.raises(SystemExit):
        cli.train_main(["--backbone", name, "--root", "nowhere"],
                       device="cpu")
    assert "feat_dim = 512" in capsys.readouterr().err
