"""Train mode of the port's `ResNetReID` against `reid_tpu.models.baseline`
at 64x32 inputs (the biased-variance trap, test_torch_train_step.py), 4
classes, a batch of 8 (4 ids x 2), f32, with one block a stage: the basic
kind (avg pooling, no bottleneck fc) and the bottleneck kind with GeM and
the bottleneck fc; the non-local block in train mode alone. Weights are
the port's random init with random running statistics (and random `w_bn`
scales in the non-local block), carried to JAX as flax variables.

  * The train-mode forward (pooled feature, logits, the new statistics)
    and the gradient of a random linear function of both outputs against
    flax's train=True apply and `jax.grad`: outputs and statistics within
    1e-4 of each tensor's largest magnitude, each parameter's gradient
    within 1e-3 of its L2 norm (L2 error), the whole gradient likewise
    (read: 3.6e-6 / 2.5e-5 whole, 3.4e-5 the worst tensor).
  * One `make_train_step` step from one carried state
    (`train_state_from_flax`) against the JAX step: every loss component
    within 1e-4 relative, the parameter update at a cosine >= 0.9995 and
    within 3% of its norm (Adam's sign noise, test_torch_train_step.py),
    the statistics within 1e-3 of their largest magnitude; then JAX's
    state after the step carried across: parameters and Adam moments
    bit-equal.
  * `train_main --backbone resnet50` for two epochs of one step at 64x32
    (--bs 8 --instance 2) on test_torch_retrieval's Market-style tree:
    the port starts from the JAX
    run's initial state (`train_state_from_flax`) and takes JAX's
    augmentation draws, the JAX run on one device; the first step's loss
    within 1e-5 relative and the second's within 1e-3 (after one Adam
    update), the checkpoint's tree equal to the JAX state's.
    Both CLIs' configurations are moved to f32 here: at a random init the
    train-mode forward of ResNet50 in bf16 lies ~19% (L2) from the f32
    program in either framework (batch statistics of 8 images at 4x2
    pixels), so a bf16 comparison would say little; the bf16 forwards are
    held block by block in test_torch_baseline.py.

The images are `images(3)`. At `images(2)`, the input of the SERes18
step tests, one pre-ReLU value of the basic trunk (layer2_0.bn1, channel
125) lies within 1.4e-6 of zero and takes opposite signs in the two
frameworks' f32 forwards (-1.36e-6 here, +6.8e-7 in flax), which moves
every gradient upstream of it by 0.3-0.5%. The non-local block is held
alone: inside a random-init trunk its logits reach the thousands and its
softmax is near one-hot, where JAX's own f32 gradient lies 1.2e-2 from
its float64 one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.config as jcfg
import reid_tpu_torch.config as tcfg
from reid_tpu.models.baseline import NonLocalBlock as JNonLocal
from reid_tpu.models.baseline import ResNetReID as JResNet
from reid_tpu.train.steps import make_train_step as jmake_train_step
from reid_tpu_torch.models.baseline import NonLocalBlock, ResNetReID
from reid_tpu_torch.train.steps import make_train_step
from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                              torch_state_dict,
                                              train_state_from_flax)
from test_torch_baseline import _block_variables, random_variables
from test_torch_retrieval import write_market_tree
from test_torch_train_data import (jax_augment_draws,  # noqa: F401
                                   place_seeded_luts, two_torch_threads)
from test_torch_train_step import B, C, H, LABELS, W, close, images
from test_torch_train_step import jax_state as seres_jax_state

KINDS = {"basic": dict(block="basic"),
         "bottleneck": dict(block="bottleneck", pooling="gem")}
X_SEED = 3


def port_model(kind):
    return ResNetReID(num_classes=C, blocks=(1, 1, 1, 1), **KINDS[kind])


def jax_model(kind):
    return JResNet(num_classes=C, blocks=(1, 1, 1, 1), **KINDS[kind])


@pytest.fixture(scope="module")
def variables():
    return {k: random_variables(port_model(k).init_weights(
        torch.Generator().manual_seed(0))) for k in KINDS}


def _weights():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(B, 512)).astype(np.float32),
            rng.normal(size=(B, C)).astype(np.float32))


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_forward_and_gradient_match_flax(variables, kind):
    v, x = variables[kind], images(X_SEED)
    r_feat, r_log = _weights()
    jm = jax_model(kind)

    @jax.jit
    def run(params, stats, xx):
        def f(p):
            (feat, logits), mut = jm.apply(
                {"params": p, "batch_stats": stats}, xx, train=True,
                mutable=["batch_stats"])
            out = jnp.sum(feat * r_feat) + jnp.sum(logits * r_log)
            return out, (feat, logits, mut["batch_stats"])
        return jax.grad(f, has_aux=True)(params)
    grads_j, (feat_j, logits_j, stats_j) = run(
        v["params"], v["batch_stats"], jnp.asarray(x))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    grads_j = torch_state_dict({"params": tree(grads_j)})
    stats_j = torch_state_dict({"batch_stats": tree(stats_j)})

    pm = port_model(kind)
    load_flax_variables(pm, v)
    feat, logits = pm(torch.from_numpy(x), train=True)
    assert feat.shape == (B, 512)
    out = (torch.sum(feat * torch.from_numpy(r_feat))
           + torch.sum(logits * torch.from_numpy(r_log)))
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(out, list(pm.parameters()),
                                allow_unused=True, materialize_grads=True)
    close(feat.detach().numpy(), np.asarray(feat_j), 1e-4)
    close(logits.detach().numpy(), np.asarray(logits_j), 1e-4)
    for name, buf in pm.named_buffers():
        close(buf.numpy(), stats_j[name].numpy(), 1e-4)
    for name, g in zip(names, grads):
        want = grads_j[name].double()
        assert float((g.double() - want).norm()) <= \
            1e-3 * float(want.norm()) + 1e-12, name
    flat = torch.cat([g.double().ravel() for g in grads])
    ref = torch.cat([grads_j[n].double().ravel() for n in names])
    assert float((flat - ref).norm()) <= 1e-3 * float(ref.norm())


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_step_matches_jax(variables, kind):
    train = dict(batch_size=B, num_instances=2, lr=1e-4, warmup_epochs=1,
                 hold_epochs=2, epochs=3)
    data = dict(height=H, width=W, pad=4)
    backbone = "baseline" if kind == "basic" else "resnet50"
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), backbone=backbone,
                                  num_classes=C, dtype="float32"),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(backbone=backbone,
                                            num_classes=C, dtype="float32"),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    js = seres_jax_state(variables[kind], jc)
    js = js.replace(apply_fn=jax_model(kind).apply, xbm=None)
    # the carried state's model: this one-block trunk (the factory builds
    # the registered depths)
    import reid_tpu_torch.models as tmodels
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodels, "build_model", lambda *a, **kw: port_model(kind))
        ts = train_state_from_flax(js, tc, 1, device="cpu")
    start = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    x = images(10, uint8=True)
    key = jax.random.PRNGKey(20)
    js, jm = jmake_train_step(jc)(js, {"images": jnp.asarray(x),
                                       "aug_key": key,
                                       "labels": jnp.asarray(LABELS)})
    ts, tm = make_train_step(tc)(ts, {
        "images": torch.from_numpy(x),
        "aug_draws": jax_augment_draws(key, B, H, W, 4),
        "labels": torch.from_numpy(LABELS)})
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    sd = torch_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, js.params), "batch_stats": jax.tree_util.tree_map(
            np.asarray, js.batch_stats)})
    names = [n for n, _ in ts.model.named_parameters()]
    upd_t = torch.cat([(p.detach() - start[n]).ravel()
                       for n, p in ts.model.named_parameters()]).double()
    upd_j = torch.cat([(sd[n] - start[n]).ravel() for n in names]).double()
    assert float(upd_t @ upd_j / (upd_t.norm() * upd_j.norm())) >= 0.9995
    assert float((upd_t - upd_j).norm()) <= 0.03 * float(upd_j.norm())
    for name, b in ts.model.named_buffers():
        close(b.numpy(), sd[name].numpy(), 1e-3)
    # JAX's state after the step, with its Adam moments, crosses exactly
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodels, "build_model", lambda *a, **kw: port_model(kind))
        carried = train_state_from_flax(js, tc, 1, device="cpu")
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert carried.opt_state["count"] == int(adam.count) == 1
    for key in ("mu", "nu"):
        want = torch_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, getattr(adam, key))})
        for n, t in zip(names, carried.opt_state[key]):
            assert torch.equal(t, want[n]), (key, n)
    for n, p in carried.model.named_parameters():
        assert torch.equal(p.detach(), sd[n]), n


def test_non_local_block_train_matches_flax():
    """Train mode (batch statistics in `w_bn`) and the gradient of a random
    linear function of the output, with a non-zero `w_bn`."""
    c = 32
    v = _block_variables(NonLocalBlock(c), 0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 8, 4, c)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    jm = JNonLocal(c)

    def f(p):
        y, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])
    grads_j, (y_j, stats_j) = jax.jit(jax.grad(f, has_aux=True))(
        v["params"])
    grads_j = torch_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, grads_j)})
    stats_j = torch_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats_j)})
    pm = NonLocalBlock(c)
    load_flax_variables(pm, v)
    y = pm(torch.from_numpy(x), train=True)
    close(y.detach().numpy(), np.asarray(y_j), 1e-4)
    for name, buf in pm.named_buffers():
        close(buf.numpy(), stats_j[name].numpy(), 1e-4)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)),
                                list(pm.parameters()))
    flat = torch.cat([g.double().ravel() for g in grads])
    ref = torch.cat([grads_j[n].double().ravel() for n in names])
    assert float((flat - ref).norm()) <= 1e-3 * float(ref.norm())
    # the kernels' gradients one by one (the biases of g, theta, phi and w
    # have a gradient of zero up to rounding: the softmax and w_bn's batch
    # statistics cancel them)
    for name, g in zip(names, grads):
        if name.endswith("kernel") or name.endswith("weight"):
            want = grads_j[name].double()
            assert float((g.double() - want).norm()) <= \
                1e-3 * float(want.norm()), name


@pytest.fixture(scope="module")
def market_tree(tmp_path_factory):
    return write_market_tree(str(tmp_path_factory.mktemp("m") / "market"))


def test_train_main_resnet50_matches_jax(market_tree, tmp_path, monkeypatch):
    import reid_tpu.parallel as jparallel
    import reid_tpu.train.image_train as jimage_train
    import reid_tpu.utils as jutils
    from reid_tpu.cli import train_main as jax_train_main
    from reid_tpu.parallel import make_mesh
    from reid_tpu_torch import cli
    from reid_tpu_torch.train import image_train, steps
    from reid_tpu_torch.utils.flax_bridge import (load_npz,
                                                  train_state_from_flax)

    import reid_tpu.cli as jcli
    flags = ["--root", market_tree, "--backbone", "resnet50", "--epochs",
             "2", "--bs", "8", "--instance", "2", "--height", "64",
             "--width", "32"]
    # both CLIs train in f32 here (their default is bf16; see the module
    # docstring)
    jcfg_of, tcfg_of = jcli._base_cfg, cli._train_cfg

    def f32(cfg):
        return cfg.replace(model=dataclasses.replace(cfg.model,
                                                     dtype="float32"))
    monkeypatch.setattr(jcli, "_base_cfg", lambda args: f32(jcfg_of(args)))
    monkeypatch.setattr(cli, "_train_cfg",
                        lambda args, n: f32(tcfg_of(args, n)))
    # the JAX run: one device, its initial state kept, no orbax write; its
    # init is the port's (XLA then compiles no init program)
    monkeypatch.setattr(jparallel, "fit_mesh", lambda bs: make_mesh(1))
    monkeypatch.setattr(jutils, "save_checkpoint", lambda path, s: path)
    place_seeded_luts(monkeypatch)
    from reid_tpu.models import build_model as jbuild
    from reid_tpu_torch.models import build_model as tbuild
    from reid_tpu_torch.utils.flax_bridge import flax_variables
    monkeypatch.setattr(
        type(jbuild("resnet50", num_classes=1)), "init",
        lambda self, *a, **k: flax_variables(tbuild(
            "resnet50", num_classes=self.num_classes, device="cpu",
            generator=torch.Generator().manual_seed(0))))
    initial = []
    jcreate = jimage_train.create_train_state

    def keep_initial(*a, **kw):
        initial.append(jcreate(*a, **kw))
        return initial[-1]
    monkeypatch.setattr(jimage_train, "create_train_state", keep_initial)
    jlosses = []
    jtrain_cnn = jimage_train.train_cnn

    def log_every_step(*a, **kw):
        state, losses = jtrain_cnn(*a, **kw, log_every=1)
        jlosses.extend(losses)
        return state, losses
    monkeypatch.setattr(jimage_train, "train_cnn", log_every_step)
    jstate = jax_train_main(flags)

    # the port from the same initial state, on JAX's augmentation draws
    keys = [jax.random.PRNGKey(1)]

    def jax_draws(generator, b, h, w, pad=10, device="cpu"):
        keys[0], k = jax.random.split(keys[0])
        return jax_augment_draws(k, b, h, w, pad)
    monkeypatch.setattr(steps, "augment_draws", jax_draws)
    monkeypatch.setattr(
        image_train, "create_train_state",
        lambda model, cfg, spe, gen: train_state_from_flax(
            initial[0], cfg, spe, device="cpu"))
    tlosses = []
    ttrain_cnn = image_train.train_cnn

    def port_log_every_step(*a, **kw):
        state, losses = ttrain_cnn(*a, **kw, log_every=1)
        tlosses.extend(losses)
        return state, losses
    monkeypatch.setattr(image_train, "train_cnn", port_log_every_step)
    tstate = cli.train_main(flags, device="cpu",
                            ckpt_dir=str(tmp_path / "ckpt"))
    assert len(tlosses) == len(jlosses) == 2
    # the first step from the same state; the second after one Adam update,
    # which moves elements whose gradient is rounding noise by ~lr either
    # way (test_torch_train_step.py; read: 6e-6 and 2.0e-4)
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses[1], jlosses[1], rtol=1e-3)
    saved = load_npz(str(tmp_path / "ckpt" /
                         "cnn_net_checkpoint_market1501.npz"))
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    assert jax.tree_util.tree_map(np.shape, saved) == \
        jax.tree_util.tree_map(np.shape, want)
    assert tstate.step == int(jstate.step) == 2
