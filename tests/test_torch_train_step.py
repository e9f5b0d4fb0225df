"""The training step of the port against the JAX package's, SERes18-IBN at
64x32 inputs with 4 classes and a batch of 8 (4 ids x 2), in f32 unless a
test says otherwise; weights are the port's random init with random
running statistics, carried to JAX as flax variables (`flax_variables`),
so no flax init is compiled here.

Why 64x32: train-mode BatchNorm takes var = E[x^2] - E[x]^2 over the
batch (flax's fast variance). At 32x16 stages 3-4 hold 2x1 pixels, each
channel's statistics rest on 16 values, the difference cancels, and the
gradient there turns on rounding: the JAX package's own jitted and eager
gradients then differ by up to 2e-3 of the largest (conv0), as far as the
port lies from either. At 64x32 the two JAX gradients agree within 3e-6
and the port within 6e-6 of the jitted one. Random BatchNorm scales make
the same cancellation appear at 64x32 (block41: 3% between jitted and
eager JAX), so the norms keep their init.

  * The train-mode forward (pooled feature, logits, the new BatchNorm
    statistics) and the gradient of a random linear function of both
    outputs with respect to every parameter, against flax's train=True
    apply and `jax.grad`, in f32 and in bf16.
  * `make_optimizers` against optax on a random parameter tree: Adam and
    SGD-Nesterov under the global-norm clip (norms above and below it),
    and the centers' rescaled SGD.
  * Three train steps from one carried state (`train_state_from_flax`):
    uint8 batches augmented on both sides under JAX's draws, XBM on with
    the gate shut for the first step; the loss of each step, then the
    params, batch_stats, centers, DCC tables, Adam moments and count, the
    XBM ring and the step.

Tolerances. The f32 forward: outputs, statistics and gradients within
1e-4 of each tensor's largest magnitude. bf16, against the f32
program: outputs, statistics and gradients within 3x flax's bf16 L2
error, the whole gradient at a cosine >= 0.95 with f32. Since the port's
convolutions that feed a norm keep their product in f32 as the compiled
flax program does (test_torch_models.py), the port's errors run up to
1.6x flax's and its gradient's cosine reads 0.970 (flax's: 0.970); when
it rounded them to bf16 they ran up to 2.3x and 0.963. Optimizers within 1e-6
relative. Three steps: every loss component within 1e-4 relative at
each step; statistics, centers, DCC tables and the XBM ring within 1e-3
of each tensor's largest magnitude; the whole parameter update and the
whole Adam moments against JAX's at a cosine >= 0.9995 and within 3% of
their norm. Adam moves an element by about lr whatever its gradient's
size, so elements whose gradient is rounding noise (0.007% after the
first step) move opposite ways in the two frameworks, later steps
inherit it (1.7% of the update's norm at lr 1e-4), and the statistics,
centers and tables of later steps see it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import reid_tpu.config as jcfg
import reid_tpu_torch.config as tcfg
from reid_tpu.losses import DCCState as JDCC
from reid_tpu.losses import init_hybrid_state as jinit_hybrid
from reid_tpu.losses import init_xbm as jinit_xbm
from reid_tpu.models import build_model as jbuild
from reid_tpu.train.state import ReIDTrainState as JState
from reid_tpu.train.state import make_optimizers as jmake_optimizers
from reid_tpu.train.steps import make_train_step as jmake_train_step
from reid_tpu_torch.models import build_model
from reid_tpu_torch.train.state import make_optimizers
from reid_tpu_torch.train.steps import make_train_step
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              torch_state_dict,
                                              train_state_from_flax)
from test_torch_train_data import (jax_augment_draws,  # noqa: F401
                                   two_torch_threads)

H, W, C, B = 64, 32, 4, 8
LABELS = np.asarray([0, 0, 2, 2, 1, 1, 3, 3], np.int32)


def close(got, want, share):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= share * scale, (err, scale)


def _random_stats(tree, rng):
    """Random running statistics, which a train step folds the batch's
    into."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def variables():
    model = build_model("seres18", num_classes=C, dtype=torch.float32,
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    v = flax_variables(model)
    # the bridge's way back is exact
    sd = torch_state_dict(v)
    assert sd.keys() == model.state_dict().keys()
    for k, t in model.state_dict().items():
        assert torch.equal(sd[k], t), k
    v["batch_stats"] = _random_stats(v["batch_stats"],
                                     np.random.default_rng(1))
    return v


def images(seed, uint8=False):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    return rng.normal(size=(B, H, W, 3)).astype(np.float32)


def _jax_train_forward(variables, x, dtype):
    """flax's train=True forward and the gradient of `_objective`,
    jitted: (param grads as a torch-named dict, feat, logits, new
    batch_stats as a torch-named dict), numpy."""
    jmodel = jbuild("seres18", num_classes=C, dtype=jnp.dtype(dtype))
    r_feat, r_log = _weights()

    @jax.jit
    def run(params, stats, x):
        def f(p):
            (feat, logits), mut = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, train=True,
                mutable=["batch_stats"])
            out = (jnp.sum(feat.astype(jnp.float32) * r_feat)
                   + jnp.sum(logits.astype(jnp.float32) * r_log))
            return out, (feat, logits, mut["batch_stats"])
        return jax.grad(f, has_aux=True)(params)
    grads, (feat, logits, stats) = run(variables["params"],
                                       variables["batch_stats"],
                                       jnp.asarray(x))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return (torch_state_dict({"params": tree(grads)}),
            np.asarray(feat, np.float32), np.asarray(logits, np.float32),
            torch_state_dict({"batch_stats": tree(stats)}))


def _weights():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(B, 512)).astype(np.float32),
            rng.normal(size=(B, C)).astype(np.float32))


def _port_train_forward(variables, x, dtype):
    """The port's train-mode forward and the gradient of the same
    objective: (grads by name, feat, logits, buffers by name, model)."""
    model = build_model("seres18", num_classes=C,
                        dtype=getattr(torch, dtype), device="cpu")
    load_flax_variables(model, variables)
    r_feat, r_log = _weights()
    feat, logits = model(torch.from_numpy(x), train=True)
    assert feat.dtype == logits.dtype == getattr(torch, dtype)
    out = (torch.sum(feat.float() * torch.from_numpy(r_feat))
           + torch.sum(logits.float() * torch.from_numpy(r_log)))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(out, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    return ({n: g.numpy() for n, g in zip(names, grads)},
            feat.detach().float().numpy(), logits.detach().float().numpy(),
            {n: b.numpy() for n, b in model.named_buffers()}, model)


@pytest.fixture(scope="module")
def f32_reference(variables):
    return _jax_train_forward(variables, images(2), "float32")


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max())


def test_train_forward_and_gradient_match_flax_f32(variables,
                                                   f32_reference):
    x = images(2)
    jgrads, feat_j, logits_j, stats_j = f32_reference
    grads, feat, logits, stats, model = _port_train_forward(
        variables, x, "float32")
    close(feat, feat_j, 1e-4)
    close(logits, logits_j, 1e-4)
    for name, buf in stats.items():
        close(buf, stats_j[name].numpy(), 1e-4)
    for name, g in grads.items():
        close(g, jgrads[name].numpy(), 1e-4)
    # the default forward of the same module returns the BNNeck feature
    assert not np.allclose(model(torch.from_numpy(x))[0].detach().numpy(),
                           feat)


def test_train_forward_and_gradient_match_flax_bf16(variables,
                                                    f32_reference):
    """bf16, each side measured against the f32 program: the port's
    outputs, statistics and gradients lie within 3x the L2 error of
    flax's bf16 program, tensor by tensor, and the whole gradient keeps a
    cosine >= 0.95 with the f32 one (flax's: 0.970, the port's: 0.970)."""
    x = images(2)
    jgrads, feat_j, logits_j, stats_j = _jax_train_forward(
        variables, x, "bfloat16")
    rgrads, feat_r, logits_r, stats_r = f32_reference
    # oneDNN's bf16 convolution on this CPU returns NaN now and then in a
    # process where XLA:CPU has run; ATen's own convolution serves here
    with torch.backends.mkldnn.flags(enabled=False):
        grads, feat, logits, stats, _ = _port_train_forward(
            variables, x, "bfloat16")
    pairs = [(feat, feat_j, feat_r), (logits, logits_j, logits_r)]
    pairs += [(stats[n], stats_j[n].numpy(), stats_r[n].numpy())
              for n in stats]
    pairs += [(grads[n], jgrads[n].numpy(), rgrads[n].numpy())
              for n in grads]
    for got, jax_bf16, ref in pairs:
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - ref) <= \
            3 * np.linalg.norm(jax_bf16 - ref) + 1e-6
    def cosine(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    flat = lambda d: np.concatenate([np.asarray(d[n]).ravel()  # noqa: E731
                                     for n in grads])
    ref = flat({n: rgrads[n].numpy() for n in grads})
    got_cos = cosine(flat(grads), ref)
    jax_cos = cosine(flat({n: jgrads[n].numpy() for n in grads}), ref)
    assert got_cos >= 0.95, (got_cos, jax_cos)


def _tree(rng, scale):
    return {"a": (scale * rng.normal(size=(3, 4))).astype(np.float32),
            "b": {"c": (scale * rng.normal(size=(5,))).astype(np.float32),
                  "d": (scale * rng.normal(size=(2, 3, 2))).astype(
                      np.float32)}}


@pytest.mark.parametrize("instances", [4, 0], ids=["adam", "sgd_nesterov"])
def test_optimizers_match_optax(instances):
    """Four updates with gradient norms 0.5x-40x the clip, the schedule
    through its warm-up, hold and cosine; the centers' update too."""
    kw = dict(train=dataclasses.replace(
        jcfg.TrainConfig(), num_instances=instances, lr=1e-2,
        warmup_epochs=1, hold_epochs=2, epochs=4))
    jc = jcfg.Config(**kw)
    tc = tcfg.Config(train=tcfg.TrainConfig(
        num_instances=instances, lr=1e-2, warmup_epochs=1, hold_epochs=2,
        epochs=4))
    tx, ctx = jmake_optimizers(jc, 1)
    ptx, pctx = make_optimizers(tc, 1)
    assert ptx.adam == (instances > 0)
    rng = np.random.default_rng(4)
    params = _tree(rng, 1.0)
    centers = rng.normal(size=(4, 6)).astype(np.float32)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tparams = [torch.from_numpy(p.copy()) for p in leaves]
    opt, copt = tx.init(params), ctx.init(centers)
    topt = ptx.init(tparams)
    tcent = torch.from_numpy(centers.copy())
    for step, scale in enumerate((0.5, 40.0, 3.0, 10.0)):
        grads = _tree(rng, scale)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        ptx.apply(tparams, [torch.from_numpy(g) for g in
                            jax.tree_util.tree_leaves(grads)], topt)
        for got, want in zip(tparams, jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        gc = (scale * rng.normal(size=centers.shape)).astype(np.float32)
        cu, copt = ctx.update(gc, copt, centers)
        centers = optax.apply_updates(centers, cu)
        tcent = pctx.apply(tcent, torch.from_numpy(gc))
        np.testing.assert_allclose(tcent.numpy(), np.asarray(centers),
                                   rtol=1e-6, atol=1e-6)
    assert topt["count"] == 4


def jax_state(variables, cfg, num_classes=C):
    """A JAX `ReIDTrainState` from `variables`, with random centers, unit
    DCC table rows and an empty XBM ring, built as `create_train_state`
    builds one (without its flax init)."""
    jmodel = jbuild("seres18", num_classes=num_classes, dtype=jnp.float32)
    tx, center_tx = jmake_optimizers(cfg, 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ls = jinit_hybrid(jax.random.PRNGKey(1), num_classes, 512)
    rng = np.random.default_rng(5)
    lut = rng.normal(size=(2, num_classes, num_classes)).astype(np.float32)
    lut /= np.linalg.norm(lut, axis=2, keepdims=True)
    ls = ls._replace(dcc=JDCC(jnp.asarray(lut[0]), jnp.asarray(lut[1])))
    return JState(step=jnp.zeros((), jnp.int32), params=params,
                  batch_stats=jax.tree_util.tree_map(
                      jnp.asarray, variables["batch_stats"]),
                  opt_state=tx.init(params), loss_state=ls,
                  center_opt_state=center_tx.init(ls.centers),
                  xbm=jinit_xbm(4 * B, 512), apply_fn=jmodel.apply, tx=tx,
                  center_tx=center_tx)


def test_three_steps_match_jax_with_xbm_gate(variables):
    train = dict(batch_size=B, num_instances=2, lr=1e-4, warmup_epochs=1,
                 hold_epochs=2, epochs=3)
    data = dict(height=H, width=W, pad=4)
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), num_classes=C,
                                  dtype="float32"),
        loss=dataclasses.replace(jcfg.LossConfig(), xbm=True),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(num_classes=C, dtype="float32"),
                     loss=tcfg.LossConfig(xbm=True),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    js = jax_state(variables, jc)
    ts = train_state_from_flax(js, tc, 1, device="cpu")
    start = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    jstep = jmake_train_step(jc, use_xbm_gate=True)
    tstep = make_train_step(tc, use_xbm_gate=True)
    for i, active in enumerate((False, True, True)):
        x = images(10 + i, uint8=True)
        key = jax.random.PRNGKey(20 + i)
        js, jm = jstep(js, {"images": jnp.asarray(x), "aug_key": key,
                            "labels": jnp.asarray(LABELS),
                            "xbm_active": jnp.asarray(active)})
        ts, tm = tstep(ts, {"images": torch.from_numpy(x),
                            "aug_draws": jax_augment_draws(key, B, H, W, 4),
                            "labels": torch.from_numpy(LABELS),
                            "xbm_active": active})
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} step {i}")
        with_xbm = float(jm["triplet"]) + 5e-4 * float(jm["center"]) + \
            float(jm["dcc"]) + (float(jm["xbm"]) if active else 0.0)
        np.testing.assert_allclose(float(jm["loss"]), with_xbm, rtol=1e-5)
    assert ts.step == int(js.step) == 3
    sd = torch_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, js.params), "batch_stats": jax.tree_util.tree_map(
            np.asarray, js.batch_stats)})
    upd_t = torch.cat([(p.detach() - start[n]).ravel()
                       for n, p in ts.model.named_parameters()]).double()
    upd_j = torch.cat([(sd[n] - start[n]).ravel()
                       for n, _ in ts.model.named_parameters()]).double()
    assert float(upd_t @ upd_j / (upd_t.norm() * upd_j.norm())) >= 0.9995
    assert float((upd_t - upd_j).norm()) <= 0.03 * float(upd_j.norm())
    for name, b in ts.model.named_buffers():
        close(b.numpy(), sd[name].numpy(), 1e-3)
    close(ts.loss_state.centers.numpy(), js.loss_state.centers, 1e-3)
    for got, want in zip(ts.loss_state.dcc, js.loss_state.dcc):
        close(got.numpy(), want, 1e-3)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert ts.opt_state["count"] == int(adam.count) == 3
    names = [n for n, _ in ts.model.named_parameters()]
    for key in ("mu", "nu"):
        want = torch_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, getattr(adam, key))})
        got = torch.cat([t.ravel() for t in ts.opt_state[key]]).double()
        ref = torch.cat([want[n].ravel() for n in names]).double()
        assert float(got @ ref / (got.norm() * ref.norm())) >= 0.9995, key
        assert float((got - ref).norm()) <= 0.03 * float(ref.norm()), key
    np.testing.assert_array_equal(ts.xbm.labels.numpy(), js.xbm.labels)
    close(ts.xbm.feats.numpy(), js.xbm.feats, 1e-3)
    assert ts.xbm.ptr == int(js.xbm.ptr) == 3 * B % (4 * B)
