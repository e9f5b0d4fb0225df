"""PLR-OSNet's training and the OSNet train path of the port against the
JAX package's: MADGRAD, `make_optimizers`' PLR-OSNet branches, one
dual-branch step of `make_plr_train_step`, `train_cnn` with
`osnet_x0_25`, and `train_main`'s OSNet runs and its refusal of
`plr_osnet`.

  * `madgrad` (inside the global-norm clip) against optax's chain of
    `clip_by_global_norm` and `reid_tpu.train.optim.madgrad` over 5 steps
    of random gradients under a warm-up cosine schedule with weight decay
    5e-4, on a random parameter tree: parameters, both moment sums and
    x0 within 1e-5 of each tensor's largest magnitude (the parameters'
    updates within 1e-4 of theirs). XLA computes `jnp.cbrt` as libm's
    powf(v, f32(1/3)); torch has no cube root and `train.optim.cbrt`
    takes v ** f32(1/3) in float64, rounded to f32: equal on >= 99.9% of
    values and within 1 ulp on all (the rest are ties of the f32
    rounding; read 0.06%). The moments then differ by an ulp here and
    there, and the FMA contractions of XLA's fused update round in other
    places than the port's separate multiplies and adds.
  * `make_optimizers` for `plr_osnet`: MADGRAD from 0.01 (weight decay
    5e-4, momentum 0.9) without PK sampling, Adam at the configured lr
    with it; the first update of each against JAX's optimizer within
    1e-5 relative.
  * One `make_plr_train_step` step from one carried state
    (`train_state_from_flax`), PLR-OSNet at 80x40 in f32 (the fresh
    init: the norms at their init and PAM's `gamma` 0, as
    `create_plr_train_state` gives it), 4 classes, a batch of 8 (4 ids x
    2), under both optimizer branches. PR 10's limits against JAX's f32
    step (gradient within 1e-3 of its norm, the update at a cosine >=
    0.9995) do not apply here: JAX's own f32 gradient lies 23% of its
    norm from the same program's float64 gradient (the local branch's
    max-pooled feature and the train-mode BatchNorms over 8 samples
    amplify every rounding; a linear function of the local branch's
    outputs reads 43-53%, of the global branch's 2-4%). So each is held
    against float64 JAX: the losses (loss, loss1, loss2) no farther from
    it than JAX's f32 losses (read 2.4e-6 / 7.3e-6 / 3.1e-5 against
    1.9e-5 / 4.6e-5 / 1.6e-4 relative) and within 1e-3 of them; the
    gradient no farther than JAX's f32 gradient (read 13% against 23%);
    the parameter update no farther from the update that JAX's optimizer
    makes of the float64 gradient, by cosine and by distance, than JAX's
    f32 step's (read MADGRAD 0.975 / 22% against 0.967 / 26%, Adam 0.923
    / 39% against 0.905 / 44%), and at a cosine >= 0.9 with it (read
    0.973 / 0.917). The centers, DCC tables and batch statistics within
    1e-3 of each tensor's largest magnitude (PR 10's limit); the step
    counted.
  * `train_cnn` with `osnet_x0_25` from one carried state on an in-memory
    split (8 ids x 4 images at 64x32, PK batches of 8), augmentation off
    as far as the configuration turns it off and JAX's draws for the
    rest: the loss of every step within 1e-4 relative (f32), as
    tests/test_torch_train_cli.py holds SERes18's, at lr 1e-5 (OSNet's
    many train-mode norms amplify Adam's sign noise: at SERes18's 1e-4
    the third step read 6.1e-4; at 1e-5, 1.0e-5 at most).
  * The port's `train_main --backbone osnet_x0_25` on a tiny Market-style
    JPEG tree: finite, a checkpoint whose tree is the flax model's; and
    `train_main --backbone plr_osnet` refused at the parser (the JAX
    package's fails at its first step: `train_cnn` casts the pair of
    features with `.astype`, and its `train_main` never calls
    `plr_train`; ROADMAP C)."""

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
from reid_tpu.losses import hybrid_loss as jhybrid_loss
from reid_tpu.losses import init_hybrid_state as jinit_hybrid
from reid_tpu.models import build_model as jbuild
from reid_tpu.train.optim import madgrad as jmadgrad
from reid_tpu.train.plr_train import PLRTrainState as JPLRState
from reid_tpu.train.plr_train import make_plr_train_step as jmake_plr_step
from reid_tpu.train.schedules import warmup_cosine_schedule as jwarmup_cosine
from reid_tpu.train.state import make_optimizers as jmake_optimizers
from reid_tpu_torch.losses import hybrid_loss
from reid_tpu_torch.models import build_model
from reid_tpu_torch.train.optim import Madgrad, cbrt
from reid_tpu_torch.train.plr_train import (PLRTrainState,
                                            create_plr_train_state,
                                            make_plr_train_step)
from reid_tpu_torch.train.schedules import warmup_cosine_schedule
from reid_tpu_torch.train.state import ModelOptimizer, make_optimizers
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              torch_state_dict,
                                              train_state_from_flax)
from test_torch_attention import close
from test_torch_train_data import two_torch_threads  # noqa: F401

H, W, C, B = 80, 40, 4, 8
LABELS = np.asarray([0, 0, 2, 2, 1, 1, 3, 3], np.int32)


def test_cbrt_is_xla_cbrt_within_one_ulp():
    rng = np.random.default_rng(0)
    v = (rng.random(50_000) * 10.0 ** rng.integers(-12, 4, 50_000)).astype(
        np.float32)
    want = np.asarray(jax.jit(jnp.cbrt)(v)).view(np.int32).astype(np.int64)
    got = cbrt(torch.from_numpy(v)).numpy().view(np.int32).astype(np.int64)
    ulps = np.abs(got - want)
    assert ulps.max() <= 1 and (ulps == 0).mean() >= 0.999
    assert float(cbrt(torch.zeros(1))) == 0.0


def random_tree(rng, scale=1.0):
    return {"a": {"kernel": (rng.normal(size=(3, 3, 2, 8)) * scale).astype(
                np.float32)},
            "b": {"kernel": (rng.normal(size=(8, 5)) * scale).astype(
                np.float32),
                  "bias": (rng.normal(size=(5,)) * scale).astype(np.float32)}}


def tensors(tree):
    """The tree's leaves in torch layout, sorted by name."""
    sd = torch_state_dict({"params": tree})
    return [sd[k].clone() for k in sorted(sd)]


def test_madgrad_matches_jax():
    rng = np.random.default_rng(1)
    params = random_tree(rng)
    grads = [random_tree(rng, scale=s) for s in (0.5, 3.0, 0.01, 1.0, 8.0)]
    spe = 2
    jsched = jwarmup_cosine(0.01, 3, spe, 1, 1, 7e-7)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     jmadgrad(jsched, momentum=0.9, weight_decay=5e-4))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = Madgrad(warmup_cosine_schedule(0.01, 3, spe, 1, 1, 7e-7), 5e-4,
                  10.0)
    tp = tensors(params)
    start = [p.clone() for p in tp]
    ts = opt.init(tp)
    step = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for g in grads:
        upd, js = step(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.apply(tp, tensors(g), ts)
    assert ts["count"] == int(js[1].count) == 5
    want = tensors(jax.tree_util.tree_map(np.asarray, jp))
    for got, w, s in zip(tp, want, start):
        close(got.numpy(), w.numpy(), 1e-5)
        close((got - s).numpy(), (w - s).numpy(), 1e-4)
    for key in ("grad_sum", "grad_sum_sq", "x0"):
        w = tensors(jax.tree_util.tree_map(np.asarray, getattr(js[1], key)))
        for got, ww in zip(ts[key], w):
            close(got.numpy(), ww.numpy(), 1e-5)


def plr_configs(num_instances, epochs=3, **train):
    train = dict(batch_size=B, num_instances=num_instances, epochs=epochs,
                 warmup_epochs=1, hold_epochs=2, **train)
    data = dict(height=H, width=W)
    model = dict(backbone="plr_osnet", num_classes=C, dtype="float32")
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), **model),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(**model),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    return jc, tc


@pytest.mark.parametrize("instances", [0, 2])
def test_make_optimizers_plr_branches(instances):
    jc, tc = plr_configs(instances)
    jtx, _ = jmake_optimizers(jc, 2)
    tx, center_tx = make_optimizers(tc, 2)
    if instances:
        assert isinstance(tx, ModelOptimizer) and tx.adam
    else:
        assert isinstance(tx, Madgrad)
        assert tx.weight_decay == 5e-4 and tx.schedule(2) == np.float32(0.01)
    rng = np.random.default_rng(2)
    params, g = random_tree(rng), random_tree(rng, 2.0)
    upd, _ = jtx.update(g, jtx.init(params), params)
    want = tensors(jax.tree_util.tree_map(np.asarray, optax.apply_updates(
        params, upd)))
    tp = tensors(params)
    tx.apply(tp, tensors(g), tx.init(tp))
    for got, w in zip(tp, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert center_tx.scale == 1.0 / 5e-4


@pytest.fixture(scope="module")
def plr_variables():
    return flax_variables(build_model(
        "plr_osnet", num_classes=C, device="cpu",
        generator=torch.Generator().manual_seed(0)))


def jax_plr_state(variables, cfg):
    """A JAX `PLRTrainState` from `variables`, with random centers and unit
    DCC table rows, built as `create_plr_train_state` builds one (without
    its flax init)."""
    tx, center_tx = jmake_optimizers(cfg, 2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rng = np.random.default_rng(5)
    losses = []
    for i, dim in enumerate((2048, 512)):
        ls = jinit_hybrid(jax.random.PRNGKey(i + 1), C, dim)
        lut = rng.normal(size=(2, C, C)).astype(np.float32)
        lut /= np.linalg.norm(lut, axis=2, keepdims=True)
        losses.append(ls._replace(dcc=JDCC(jnp.asarray(lut[0]),
                                           jnp.asarray(lut[1]))))
    return JPLRState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), loss1=losses[0], loss2=losses[1],
        copt1=center_tx.init(losses[0].centers),
        copt2=center_tx.init(losses[1].centers)), tx, center_tx


def jax_plr_gradient(js, cfg, x, dtype=jnp.float32):
    """The gradient of PLR-OSNet's loss (`make_plr_train_step`'s loss_fn)
    with respect to the parameters, jitted, in torch naming; with float64
    the model, its variables and the loss states in float64 (under
    `jax.enable_x64`)."""
    jm = jbuild("plr_osnet", num_classes=C, dtype=dtype)
    labels = jnp.asarray(LABELS)
    cast = lambda t: jax.tree_util.tree_map(   # noqa: E731
        lambda a: jnp.asarray(np.asarray(a), dtype), t)
    ls1, ls2 = (ls._replace(centers=cast(ls.centers), dcc=cast(ls.dcc))
                for ls in (js.loss1, js.loss2))

    def loss(p):
        (feats, logits), _ = jm.apply(
            {"params": p, "batch_stats": cast(js.batch_stats)},
            jnp.asarray(x, dtype), train=True, mutable=["batch_stats"])
        l1, _ = jhybrid_loss(ls1, feats[0], logits[0], labels, cfg.loss)
        l2, _ = jhybrid_loss(ls2, feats[1], logits[1], labels, cfg.loss)
        return l1 + l2, {"loss": l1 + l2, "loss1": l1, "loss2": l2}
    g, losses = jax.jit(jax.grad(loss, has_aux=True))(cast(js.params))
    g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
    return g, {k: float(v) for k, v in losses.items()}


def images(seed):
    """Images whose mean follows the identity (a learnable batch)."""
    x = np.random.default_rng(seed).normal(size=(B, H, W, 3)).astype(
        np.float32) * 0.5
    return x + (LABELS / C)[:, None, None, None].astype(np.float32)


@pytest.fixture(scope="module")
def plr_gradients(plr_variables):
    """JAX's gradient and losses of one batch from the carried state, in
    f32 and in float64 (the optimizer does not enter)."""
    jc, _ = plr_configs(2)
    js, _, _ = jax_plr_state(plr_variables, jc)
    x = images(3)
    g32, losses32 = jax_plr_gradient(js, jc, x)
    with jax.enable_x64(True):
        g64, losses64 = jax_plr_gradient(js, jc, x, jnp.float64)
    return x, g32, g64, losses64


@pytest.mark.parametrize("instances", [0, 2])
def test_plr_step_matches_jax(plr_variables, plr_gradients, instances):
    x, g32, g64, exact = plr_gradients
    jc, tc = plr_configs(instances)
    js, jtx, jctx = jax_plr_state(plr_variables, jc)
    ts = train_state_from_flax(js, tc, 2, device="cpu")
    assert isinstance(ts, PLRTrainState)
    assert isinstance(ts.tx, Madgrad if instances == 0 else ModelOptimizer)
    assert ts.loss1.centers.shape == (C, 2048)
    assert ts.loss2.centers.shape == (C, 512)
    names = [n for n, _ in ts.model.named_parameters()]

    def flat(tree):
        sd = torch_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, tree)})
        return torch.cat([sd[n].ravel() for n in names]).double()

    # the gradient, from the carried state: no farther from float64 than
    # JAX's own f32 program
    (v1, v2), (y1, y2) = ts.model(torch.from_numpy(x), train=True)
    lab = torch.from_numpy(LABELS)
    total = hybrid_loss(ts.loss1, v1, y1, lab, tc.loss)[0] + hybrid_loss(
        ts.loss2, v2, y2, lab, tc.loss)[0]
    gt = torch.cat([g.ravel() for g in torch.autograd.grad(
        total, list(ts.model.parameters()))]).double()
    gj, ge = flat(g32), flat(g64)
    assert float((gt - ge).norm()) <= float((gj - ge).norm())
    # the update JAX's optimizer makes of the float64 gradient
    upd, _ = jax.jit(jtx.update)(g64, js.opt_state, js.params)
    upd_e = flat(upd)
    # reload: the forward above moved the running statistics
    ts = train_state_from_flax(js, tc, 2, device="cpu")
    start = {n: p.detach().clone() for n, p in ts.model.named_parameters()}

    batch = {"images": jnp.asarray(x), "labels": jnp.asarray(LABELS)}
    js, jm = jmake_plr_step(jc, jbuild("plr_osnet", num_classes=C), jtx,
                            jctx)(js, batch)
    ts, tm = make_plr_train_step(tc)(ts, {
        "images": torch.from_numpy(x), "labels": torch.from_numpy(LABELS)})
    assert ts.step == int(js.step) == 1
    assert tm.keys() == jm.keys() == {"loss", "loss1", "loss2"}
    for k in jm:
        assert abs(tm[k].item() - exact[k]) <= abs(float(jm[k]) - exact[k])
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    sd = torch_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, js.params), "batch_stats": jax.tree_util.tree_map(
            np.asarray, js.batch_stats)})
    upd_t = torch.cat([(p.detach() - start[n]).ravel()
                       for n, p in ts.model.named_parameters()]).double()
    upd_j = torch.cat([(sd[n] - start[n]).ravel() for n in names]).double()

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))
    assert cos(upd_t, upd_e) >= cos(upd_j, upd_e)
    assert float((upd_t - upd_e).norm()) <= float((upd_j - upd_e).norm())
    assert cos(upd_t, upd_j) >= 0.9
    for bname, b in ts.model.named_buffers():
        close(b.numpy(), sd[bname].numpy(), 1e-3)
    for got, want in ((ts.loss1, js.loss1), (ts.loss2, js.loss2)):
        close(got.centers.numpy(), np.asarray(want.centers), 1e-3)
        for a, b in zip(got.dcc, want.dcc):
            close(a.numpy(), np.asarray(b), 1e-3)


def test_create_plr_train_state():
    _, tc = plr_configs(0)
    state = create_plr_train_state(tc, 2, device="cpu")
    assert isinstance(state.tx, Madgrad) and state.step == 0
    assert state.loss1.centers.shape == (C, 2048)
    assert state.loss2.centers.shape == (C, 512)
    assert set(state.opt_state) == {"count", "grad_sum", "grad_sum_sq", "x0"}
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state["x0"],
                                                 state.params()))


def test_train_cnn_osnet_matches_jax_loss_trace(tmp_path, monkeypatch):
    """`train_cnn` (what `train_main --backbone osnet_x0_25` runs) against
    the JAX package's from one carried state: the loss of every step."""
    from reid_tpu.data.dataset import synthetic_dataset as jsynthetic
    from reid_tpu.parallel import make_mesh
    from reid_tpu.train.image_train import train_cnn as jtrain_cnn
    from reid_tpu_torch.data.dataset import synthetic_dataset
    from reid_tpu_torch.train import steps
    from reid_tpu_torch.train.image_train import train_cnn
    from test_torch_train_data import jax_augment_draws, place_seeded_luts
    from test_torch_train_step import jax_state
    import reid_tpu.utils as jutils

    h, w, n_ids = 64, 32, 8
    train = dict(batch_size=B, num_instances=2, epochs=1, lr=1e-5,
                 warmup_epochs=1, hold_epochs=2)
    data = dict(height=h, width=w, pad=0, flip_prob=0.0,
                random_erasing_prob=0.0)
    model = dict(backbone="osnet_x0_25", num_classes=n_ids, dtype="float32")
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), **model),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(**model),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    v = flax_variables(build_model("osnet_x0_25", num_classes=n_ids,
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(0)))
    js = jax_state(v, jc, num_classes=n_ids)
    js = js.replace(apply_fn=jbuild("osnet_x0_25", num_classes=n_ids).apply,
                    xbm=None)
    ts = train_state_from_flax(js, tc, 1, device="cpu")
    keys = [jax.random.PRNGKey(jc.train.seed + 1)]

    def jax_draws(generator, b, hh, ww, pad=10, device="cpu"):
        keys[0], k = jax.random.split(keys[0])
        return jax_augment_draws(k, b, hh, ww, pad)
    monkeypatch.setattr(steps, "augment_draws", jax_draws)
    monkeypatch.setattr(jutils, "save_checkpoint", lambda path, state: path)
    place_seeded_luts(monkeypatch)
    jds = jsynthetic(n=32, num_pids=n_ids, height=h, width=w)
    tds = synthetic_dataset(n=32, num_pids=n_ids, height=h, width=w)
    js, jloss = jtrain_cnn(jc, jds, state=js, log_every=1,
                           ckpt_dir=str(tmp_path / "j"), mesh=make_mesh(1))
    ts, tloss = train_cnn(tc, tds, state=ts, log_every=1,
                          ckpt_dir=str(tmp_path / "t"), device="cpu")
    assert len(tloss) == len(jloss) >= 3
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


def test_train_main_osnet_and_plr_refusal(tmp_path, capsys):
    """The port's `train_main --backbone osnet_x0_25`, one step, on a tiny
    Market-style JPEG tree: finite parameters and a checkpoint whose tree
    is the flax model's. `--backbone plr_osnet` stops at the parser, and
    names the library loop."""
    from reid_tpu_torch.cli import train_main
    from reid_tpu_torch.utils.flax_bridge import load_npz
    from test_torch_retrieval import write_market_tree
    root = write_market_tree(str(tmp_path / "market"))
    flags = ["--root", root, "--epochs", "1", "--bs", "8", "--instance", "2",
             "--height", "64", "--width", "32"]
    with torch.backends.mkldnn.flags(enabled=False):
        state = train_main(flags + ["--backbone", "osnet_x0_25"],
                           device="cpu", ckpt_dir=str(tmp_path / "ck"))
    assert state.step >= 1
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())
    saved = load_npz(str(tmp_path / "ck" / "cnn_net_checkpoint_market1501"
                                          ".npz"))
    jm = jbuild("osnet_x0_25", num_classes=state.loss_state.centers.shape[0])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)), train=False))
    assert jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), saved) == \
        jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    capsys.readouterr()
    with pytest.raises(SystemExit):
        train_main(flags + ["--backbone", "plr_osnet"], device="cpu")
    assert "reid_tpu_torch.train.plr_train" in capsys.readouterr().err
