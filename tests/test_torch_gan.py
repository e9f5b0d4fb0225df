"""The port's GAN (`gan/models.py`, `gan/train.py`, `gan/driver.py`,
`cli.gan_main`, `cli.lsro_main`) against the JAX package's, in f32 at
small widths (ngf = ndf = 8, nz 16), with the flax variables crossing
through the bridge and numpy inputs from a seed. Each JAX reference runs
once, in a module-scoped fixture.

  * Transposed convs: flax's (4, 2)/(4, 2) VALID kernel from 1x1 (the
    plain G's first layer) bit-equal; the overlapping 4x4/2 and 6x6/2
    SAME kernels within 1e-6 of the largest output (XLA:CPU and oneDNN
    sum the taps in their own orders, so an output moves by an ulp).
  * Every module from the port's init (handed to JAX through the bridge,
    so that JAX compiles no init) in train mode at rtol = atol = 1e-5 of
    each output's largest magnitude, with the statistics it leaves
    (BatchNorm's running mean and var, the spectral norms' `u` and
    `sigma`), and in eval mode, which leaves them as they were
    (`SelfAttention` with gamma non-zero; `CategoricalConditionalBN` with
    random tables; G spectral with self-attention and classes, and plain;
    D spectral with self-attention, plain, Wasserstein and VAE-headed;
    the VAE at a batch of 8, its train mode at 5e-5: its 32,768-wide
    dense layer sums in another order than XLA's and the train-mode
    norms over 8 rows carry that (read 1.6e-5); its decoder).
  * Six DCGAN steps (spectral G and D, a batch of 4) fed JAX's own z:
    G steps at the 3rd and 6th, the labels flip at the 5th, the EMA
    follows. Each step's losses within 1e-4 relative. Adam moves each
    element by about lr whatever its gradient's size, so elements whose
    gradient is noise-sized step either way (a GenBlock's conv1 bias,
    before a train-mode BatchNorm, has a true gradient of 0; read 1.7x
    apart): after the sixth step Adam's first moments (the gradients)
    within 3e-3 of their norm (read 4.4e-4 for G, 2.0e-3 for D), the
    updates of G, D and G's EMA at a cosine >= 0.9999 and within 1% of
    their norm, the statistics within 1e-3 of each tensor's largest
    magnitude (read 2.9e-4) and the EMA generator's eval output within
    1e-3.
  * One VAE-GAN step with BCE (spectral D) and one with Wasserstein +
    gradient penalty (D with the VAE head, whose BatchNorm the penalty's
    gradient of a gradient runs through), fed JAX's eps: the losses
    within 1e-4 relative; Adam's first moments within 3e-3 of their norm
    (read 9.1e-4 / 1.2e-3 for the VAE); the one-step update (lr
    sign(g) but for tiny gradients) at a cosine >= 0.99; the statistics
    within 1e-4 of each tensor's largest magnitude.
  * `lsro_loss` within 1e-6.
  * `train_lsro_baseline` for one epoch (baseline at 64x32, 8 real and 4
    generated images, batches of 4), the port's init handed JAX's: the
    epoch's loss within 1e-4 relative and the accuracy equal.
  * `get_groups` on planted colour groups with JAX's k-means rows: the
    labels identical; `make_resnet_embed_fn` on tests/test_gan.py's
    random torchvision-layout ResNet-50 state dict: features within 1e-4
    of the largest.
  * `gan_main` (DCGAN with two groups, and the VAE-GAN) and `lsro_main`
    on a tiny Market tree on the CPU: the images and checkpoints written,
    the count of images, the checkpoint read back equal to the state it
    came from, and both CLIs' flags and defaults equal to JAX's. The
    randomness of the drivers differs from JAX's (torch generators), so
    the library tests above hold the numbers.
"""

import glob
import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import reid_tpu.gan as jgan
from reid_tpu.gan import models as jm
from reid_tpu.gan import train as jt
from reid_tpu_torch import cli
from reid_tpu_torch import gan as tgan
from reid_tpu_torch.gan import driver as tdrv
from reid_tpu_torch.gan import models as tm
from reid_tpu_torch.gan import train as tt
from reid_tpu_torch.models.layers import ConvTranspose2d
from reid_tpu_torch.ops import kmeans as tkm
from reid_tpu_torch.train.optim import Adam
from reid_tpu_torch.utils.flax_bridge import (flatten, flax_variables,
                                              load_flax_variables,
                                              torch_state_dict)
from test_torch_attention import close, tree
from test_torch_train_data import two_torch_threads  # noqa: F401

NZ, NGF, NDF, B = 16, 8, 8, 4
IMG = (128, 64, 3)


def images(seed, n=B):
    return np.random.default_rng(seed).uniform(-1, 1, (n, *IMG)).astype(
        np.float32)


def hold_tree(got, want, share):
    """Two flax-layout trees: the same leaves, each within `share` of its
    largest magnitude."""
    got, want = flatten(tree(got)), flatten(tree(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        close(got[k], want[k], share)


def torch_layout(module, params):
    """A flax-layout params tree as `module`'s named tensors."""
    return torch_state_dict({"params": tree(params)}, [
        n for n, m in module.named_modules()
        if isinstance(m, ConvTranspose2d)])


def hold_trained(module, want, start, cosine, rel_norm):
    """`module`'s trained parameters against JAX's (`want`, flax layout)
    from one start: the update of the whole model (now - start against
    want - start) at a cosine >= `cosine` and within `rel_norm` of its
    norm. Adam steps each element by about lr whatever its gradient's
    size, so an element whose gradient is rounding noise (a bias before
    a train-mode BatchNorm, whose true gradient is 0) or tiny steps
    either way: the gradients are held through `hold_moments`, the
    parameters as one update."""
    want, start = torch_layout(module, want), torch_layout(module, start)
    dot = gg = ww = dd = 0.0
    with torch.no_grad():
        for n, p in module.named_parameters():
            ug, uw = p - start[n], want[n] - start[n]
            dot += float((ug * uw).sum())
            gg += float((ug * ug).sum())
            ww += float((uw * uw).sum())
            dd += float(torch.square(ug - uw).sum())
    cos, rel = dot / np.sqrt(gg * ww), np.sqrt(dd / ww)
    assert cos >= cosine and rel <= rel_norm, (cos, rel)


def hold_moments(module, opt_state, want_mu, rel_norm):
    """Adam's first moment (a running blend of the gradients) of `module`
    against optax's (`want_mu`, a flax-layout tree): within `rel_norm`
    of its norm over the whole model."""
    want = torch_layout(module, want_mu)
    names = [n for n, _ in module.named_parameters()]
    assert set(names) == set(want)
    dd = sum(float(torch.square(m - want[n]).sum())
             for n, m in zip(names, opt_state["mu"]))
    rel = np.sqrt(dd / sum(float(torch.square(want[n]).sum())
                           for n in names))
    assert rel <= rel_norm, rel


def hold_stats(module, want, share=1e-5):
    hold_tree(flatten_stats(flax_variables(module)["batch_stats"]),
              flatten_stats(want), share)


def flatten_stats(stats):
    """A batch_stats tree keyed by the port's buffer names, so that the
    flax tree's "conv1/kernel/u" keys and the nested ones compare."""
    return {k: np.asarray(v) for k, v in torch_state_dict(
        {"batch_stats": tree(stats)}).items()}


@pytest.mark.parametrize("k,s,pad,hw,bias", [
    ((4, 2), (4, 2), "VALID", (1, 1), False),
    ((4, 4), (2, 2), "SAME", (4, 2), True),
    ((6, 6), (2, 2), "SAME", (16, 8), False)])
def test_transposed_conv_matches_flax(k, s, pad, hw, bias):
    import flax.linen as nn
    x = np.random.default_rng(1).normal(size=(2, *hw, 6)).astype(np.float32)
    m = nn.ConvTranspose(5, k, strides=s, padding=pad, use_bias=bias)
    v = tree(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if bias:
        v["params"]["bias"] = np.linspace(-1, 1, 5, dtype=np.float32)
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    t = ConvTranspose2d(6, 5, k, s, padding=pad, bias=bias)
    load_flax_variables(t, v)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if k == (4, 2):
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def randomize_tables(v, rng):
    """Non-trivial CCBN tables and attention gammas (ones / zeros / 0 at
    init)."""
    for path, leaf in flatten(v["params"]).items():
        node = v["params"]
        for p in path[:-1]:
            node = node[p]
        if path[-1] == "embedding":
            node["embedding"] = rng.uniform(0.5, 1.5, leaf.shape).astype(
                np.float32)
        elif path[-1] == "gamma":
            node["gamma"] = np.asarray([0.6], np.float32)
    return v


MODULES = {
    "self_attention": (lambda: jm.SelfAttention(), lambda: tm.SelfAttention(
        16), "x16", False),
    "ccbn": (lambda: jm.CategoricalConditionalBN(3, 16),
             lambda: tm.CategoricalConditionalBN(3, 16), "x16y", True),
    "generator_spectral": (
        lambda: jm.Generator(nz=NZ, ngf=NGF, self_attn=True, num_classes=3),
        lambda: tm.Generator(nz=NZ, ngf=NGF, self_attn=True, num_classes=3),
        "zy", True),
    "generator_plain": (lambda: jm.Generator(nz=NZ, ngf=NGF, spectral=False),
                        lambda: tm.Generator(nz=NZ, ngf=NGF, spectral=False),
                        "z", True),
    "discriminator_spectral": (
        lambda: jm.Discriminator(ndf=NDF, self_attn=True),
        lambda: tm.Discriminator(ndf=NDF, self_attn=True), "img", True),
    "discriminator_plain": (
        lambda: jm.Discriminator(ndf=NDF, spectral=False),
        lambda: tm.Discriminator(ndf=NDF, spectral=False), "img", True),
    "discriminator_wasserstein": (
        lambda: jm.Discriminator(ndf=NDF, wasserstein=True),
        lambda: tm.Discriminator(ndf=NDF, wasserstein=True), "img", True),
    "discriminator_vae": (
        lambda: jm.Discriminator(ndf=NDF, spectral=False, vae=True),
        lambda: tm.Discriminator(ndf=NDF, spectral=False, vae=True), "img",
        True),
    "vae": (lambda: jm.VAE(zdim=NZ), lambda: tm.VAE(zdim=NZ), "vae", True),
}


def module_inputs(kind, rng):
    if kind == "x16":
        return (rng.normal(size=(B, 8, 4, 16)).astype(np.float32),)
    if kind == "x16y":
        return (rng.normal(size=(B, 8, 4, 16)).astype(np.float32),
                np.asarray([0, 2, 1, 2]))
    if kind in ("zy", "z"):
        z = rng.normal(size=(B, NZ)).astype(np.float32)
        return (z, np.asarray([0, 2, 1, 2])) if kind == "zy" else (z,)
    if kind == "img":
        return (images(7),)
    return (images(8, n=8),)


def port_variables(factory, rng):
    """The port module's init (flax's initializers, a seeded generator),
    its running means and variances moved off 0 / 1, as a flax tree:
    both packages start from these, and JAX compiles no init."""
    torch.manual_seed(0)
    mod = factory()
    if hasattr(mod, "init_weights"):
        mod.init_weights(torch.Generator().manual_seed(0))
    v = flax_variables(mod)
    for path, leaf in flatten(v["batch_stats"]).items():
        node = v["batch_stats"]
        for p in path[:-1]:
            node = node[p]
        if path[-1] == "mean":
            node["mean"] = rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        elif path[-1] == "var":
            node["var"] = rng.uniform(0.5, 1.5, leaf.shape).astype(
                np.float32)
    return randomize_tables(v, rng)


@pytest.fixture(scope="module")
def module_runs():
    """Each module's JAX train-mode output and statistics and its eval
    output, from the port's init, in one jitted call; the VAE with the
    eps it drew and its decoder on prior z."""
    runs = {}
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(5)
    for name, (jmod, tmod, kind, train) in MODULES.items():
        m = jmod()
        args = tuple(map(jnp.asarray, module_inputs(kind, rng)))
        v = port_variables(tmod, rng)
        extra = {}
        if kind == "vae":
            extra = {"eps": np.asarray(jax.random.normal(key, (8, NZ))),
                     "z": rng.normal(size=(3, NZ)).astype(np.float32)}

            def run(vv, x, z):
                out, mut = m.apply(vv, x, key, train=True,
                                   mutable=["batch_stats"])
                return (out, mut["batch_stats"],
                        m.apply(vv, x, key, train=False),
                        m.apply(vv, z, train=False, method=jm.VAE.decode))
            out, stats, ev, extra["decode"] = jax.jit(run)(
                v, *args, jnp.asarray(extra["z"]))
        elif train:
            def run(vv, *a):
                out, mut = m.apply(vv, *a, train=True,
                                   mutable=["batch_stats"])
                return (out, mut.get("batch_stats", {}),
                        m.apply(vv, *a, train=False))
            out, stats, ev = jax.jit(run)(v, *args)
        else:
            out, stats, ev = jax.jit(m.apply)(v, *args), None, None
        runs[name] = dict(v=v, args=[np.asarray(a) for a in args],
                          out=tree(out), stats=tree(stats), eval=tree(ev),
                          **tree(extra))
    return runs


def port_call(mod, name, run, train):
    args = [torch.from_numpy(np.asarray(a)) for a in run["args"]]
    if name == "vae":
        args.append(torch.from_numpy(run["eps"]))
    if MODULES[name][3]:
        return mod(*args, train=train)
    return mod(*args)


def hold_out(got, want, share=1e-5):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            hold_out(g, w, share)
    else:
        close(got.detach(), want, share)


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_flax(name, module_runs):
    run = module_runs[name]
    mod = MODULES[name][1]()
    load_flax_variables(mod, run["v"])
    if not MODULES[name][3]:
        hold_out(port_call(mod, name, run, False), run["out"])
        return
    # the VAE's encoder sums 32,768 products a feature (enc_fc) in
    # another order than XLA's, and its train-mode norms over 8 rows
    # carry that into the reconstruction (read 1.6e-5)
    share = 5e-5 if name == "vae" else 1e-5
    hold_out(port_call(mod, name, run, True), run["out"], share)
    if run["stats"]:
        hold_stats(mod, run["stats"], share)
    fresh = MODULES[name][1]()
    load_flax_variables(fresh, run["v"])
    with torch.no_grad():
        hold_out(port_call(fresh, name, run, False), run["eval"])
    # eval mode leaves the statistics (and the spectral u) as they were
    hold_stats(fresh, run["v"].get("batch_stats", {}), 0.0)
    if name == "vae":
        with torch.no_grad():
            close(fresh.decode(torch.from_numpy(run["z"])), run["decode"],
                  1e-5)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def load(module, params, stats):
    load_flax_variables(module, {"params": params, "batch_stats": stats})
    return module


def adam():
    return optax.adam(2e-4, b1=0.5, b2=0.999)


@pytest.fixture(scope="module")
def dcgan_run():
    """Six JAX DCGAN steps (spectral G and D, as `create_gan_state` builds
    them, from the port's init) on fixed real batches, with the z each
    step drew."""
    rng = np.random.default_rng(11)
    gv = port_variables(lambda: tm.Generator(nz=NZ, ngf=NGF), rng)
    dv = port_variables(lambda: tm.Discriminator(ndf=NDF), rng)
    gen, disc = jm.Generator(nz=NZ, ngf=NGF), jm.Discriminator(ndf=NDF)
    g_tx, d_tx = adam(), adam()
    state = jt.GANState(
        step=jnp.zeros((), jnp.int32), g_params=gv["params"],
        g_stats=gv["batch_stats"], d_params=dv["params"],
        d_stats=dv["batch_stats"], g_opt=g_tx.init(gv["params"]),
        d_opt=d_tx.init(dv["params"]), ema_params=gv["params"])
    start = tree(state)
    step = jt.make_dcgan_steps(gen, disc, g_tx, d_tx, nz=NZ)
    reals, draws, losses = [], [], []
    for i in range(6):
        real = images(20 + i)
        key = jax.random.PRNGKey(100 + i)
        kz1, kz2 = jax.random.split(key)
        draws.append([np.asarray(jax.random.normal(k, (B, NZ)))
                      for k in (kz1, kz2)])
        state, m = step(state, jnp.asarray(real), key)
        reals.append(real)
        losses.append((float(m["d_loss"]), float(m["g_loss"])))
    want = jax.jit(lambda v, z: gen.apply(v, z, train=False))(
        {"params": state.ema_params, "batch_stats": state.g_stats},
        jnp.asarray(draws[0][0]))
    return start, reals, draws, losses, tree(state), np.asarray(want)


def test_dcgan_steps_match_jax(dcgan_run):
    start, reals, draws, losses, end, ema_images = dcgan_run
    state, g_tx, d_tx = tt.create_gan_state(
        load(tm.Generator(nz=NZ, ngf=NGF), start.g_params, start.g_stats),
        load(tm.Discriminator(ndf=NDF), start.d_params, start.d_stats))
    step = tt.make_dcgan_steps(g_tx, d_tx)
    for i, (real, (z, z2)) in enumerate(zip(reals, draws)):
        state, m = step(state, torch.from_numpy(real), torch.from_numpy(z),
                        torch.from_numpy(z2))
        d, g = losses[i]
        assert abs(float(m["d_loss"]) - d) <= 1e-4 * abs(d), (i, m, d)
        if i % 3 == 2:
            assert abs(float(m["g_loss"]) - g) <= 1e-4 * abs(g), (i, m, g)
        else:
            assert float(m["g_loss"]) == g == 0.0
    assert state.step == 6 == int(end.step)
    gv, dv = (flax_variables(m) for m in (state.generator,
                                          state.discriminator))
    hold_moments(state.generator, state.g_opt, end.g_opt[0].mu, 3e-3)
    hold_moments(state.discriminator, state.d_opt, end.d_opt[0].mu, 3e-3)
    hold_trained(state.generator, end.g_params, start.g_params, 0.9999,
                 1e-2)
    hold_trained(state.discriminator, end.d_params, start.d_params, 0.9999,
                 1e-2)
    hold_trained(tt.ema_generator(state), end.ema_params, start.g_params,
                 0.9999, 1e-2)
    hold_tree(flatten_stats(gv["batch_stats"]), flatten_stats(end.g_stats),
              1e-3)
    hold_tree(flatten_stats(dv["batch_stats"]), flatten_stats(end.d_stats),
              1e-3)
    # the EMA generator samples in eval mode
    with torch.no_grad():
        got = tt.ema_generator(state)(torch.from_numpy(draws[0][0]))
    close(got, ema_images, 1e-3)


VAEGAN = {"bce": dict(wasserstein=False, disc=dict(ndf=NDF)),
          "wasserstein_gp": dict(wasserstein=True, disc=dict(
              ndf=NDF, spectral=False, vae=True, wasserstein=True))}


class VGState(NamedTuple):
    """The fields of `make_vaegan_steps`' state, which its step reads."""
    step: Any
    vae_params: Any
    vae_stats: Any
    d_params: Any
    d_stats: Any
    vae_opt: Any
    d_opt: Any


@pytest.fixture(scope="module")
def vaegan_runs(module_runs):
    """One JAX VAE-GAN step of each kind from the port's init (the VAE's
    from `module_runs`), with the eps it drew."""
    runs = {}
    rng = np.random.default_rng(12)
    vv = module_runs["vae"]["v"]
    for name, cfg in VAEGAN.items():
        dv = port_variables(lambda: tm.Discriminator(**cfg["disc"]), rng)
        vae, disc = jm.VAE(zdim=NZ), jm.Discriminator(**cfg["disc"])
        _, step = jt.make_vaegan_steps(vae, disc, adam(), adam(), zdim=NZ,
                                       wasserstein=cfg["wasserstein"])
        state = VGState(jnp.zeros((), jnp.int32), vv["params"],
                        vv["batch_stats"], dv["params"], dv["batch_stats"],
                        adam().init(vv["params"]), adam().init(dv["params"]))
        real = images(30)
        key = jax.random.PRNGKey(9)
        k1, k2, _ = jax.random.split(key, 3)
        eps = np.asarray(jax.random.normal(k1, (B, NZ)))
        gp_eps = np.asarray(jax.random.uniform(k2, (B, 1, 1, 1)))
        state, m = step(state, jnp.asarray(real), key)
        # what the test reads, fetched once (the VAE is 71M parameters)
        end = tree(dict(vae_params=state.vae_params,
                        vae_stats=state.vae_stats, d_params=state.d_params,
                        d_stats=state.d_stats, vae_mu=state.vae_opt[0].mu,
                        d_mu=state.d_opt[0].mu))
        runs[name] = dict(start=(vv, dv), real=real, eps=eps, gp_eps=gp_eps,
                          metrics={k: float(v) for k, v in m.items()},
                          end=end)
    return runs


@pytest.mark.parametrize("name", list(VAEGAN))
def test_vaegan_step_matches_jax(name, vaegan_runs):
    run, cfg = vaegan_runs[name], VAEGAN[name]
    (vv, dv), end = run["start"], run["end"]
    init, step = tt.make_vaegan_steps(Adam(2e-4, b1=0.5), Adam(2e-4, b1=0.5),
                                      wasserstein=cfg["wasserstein"])
    state = init(load(tm.VAE(zdim=NZ), vv["params"], vv["batch_stats"]),
                 load(tm.Discriminator(**cfg["disc"]), dv["params"],
                      dv["batch_stats"]))
    state, m = step(state, torch.from_numpy(run["real"]),
                    torch.from_numpy(run["eps"]),
                    torch.from_numpy(run["gp_eps"]))
    for k, want in run["metrics"].items():
        assert abs(float(m[k]) - want) <= 1e-4 * abs(want), (k, m, want)
    assert state.step == 1
    hold_moments(state.vae, state.vae_opt, end["vae_mu"], 3e-3)
    hold_moments(state.discriminator, state.d_opt, end["d_mu"], 3e-3)
    # one Adam step: lr sign(g) but for tiny gradients
    hold_trained(state.vae, end["vae_params"], vv["params"], 0.99, 0.2)
    hold_trained(state.discriminator, end["d_params"], dv["params"], 0.99,
                 0.2)
    hold_stats(state.vae, end["vae_stats"], 1e-4)
    hold_stats(state.discriminator, end["d_stats"], 1e-4)


def test_lsro_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (12, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 12)
    flags = (rng.random(12) < 0.4).astype(np.float32)
    want = float(jt.lsro_loss(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(flags)))
    got = float(tt.lsro_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             torch.from_numpy(flags)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(6)
    e, p = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2))
    want = np.asarray(jt.ema_update({"w": jnp.asarray(e)},
                                    {"w": jnp.asarray(p)}, 0.999)["w"])
    got = tt.ema_update([torch.from_numpy(e.copy())], [torch.from_numpy(p)],
                        0.999)[0]
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def planted_groups(rng, n=16, hw=(32, 16)):
    """Two colour groups (dark red, bright blue) with noise, as uint8."""
    imgs = rng.integers(0, 30, (n, *hw, 3)).astype(np.int64)
    imgs[: n // 2, ..., 0] += 180
    imgs[n // 2:, ..., 2] += 200
    return np.clip(imgs, 0, 255).astype(np.uint8)


def test_get_groups_matches_jax(monkeypatch):
    imgs = planted_groups(np.random.default_rng(7))
    want = np.asarray(jgan.get_groups(imgs, 2))
    rows = np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(imgs),
                                        (2,), replace=False))
    monkeypatch.setattr(tkm, "init_indices", lambda n, k, generator=None:
                        torch.from_numpy(rows))
    got = tgan.get_groups(imgs, 2, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:8])) == 1 and len(set(got[8:])) == 1
    assert got[0] != got[8]


def resnet50_state_dict(path):
    """tests/test_gan.py's random torchvision-layout ResNet-50."""
    g = torch.Generator().manual_seed(0)
    sd = {}

    def conv(name, o, i, k):
        sd[name] = torch.randn((o, i, k, k), generator=g) * 0.05

    def bn(name, c):
        sd[name + ".weight"] = torch.rand(c, generator=g) + 0.5
        sd[name + ".bias"] = torch.randn(c, generator=g) * 0.05
        sd[name + ".running_mean"] = torch.randn(c, generator=g) * 0.05
        sd[name + ".running_var"] = torch.rand(c, generator=g) * 0.5 + 0.75

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (p, nb) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)), 1):
        for b in range(nb):
            t = f"layer{li}.{b}"
            conv(f"{t}.conv1.weight", p, cin, 1)
            bn(f"{t}.bn1", p)
            conv(f"{t}.conv2.weight", p, p, 3)
            bn(f"{t}.bn2", p)
            conv(f"{t}.conv3.weight", p * 4, p, 1)
            bn(f"{t}.bn3", p * 4)
            if b == 0:
                conv(f"{t}.downsample.0.weight", p * 4, cin, 1)
                bn(f"{t}.downsample.1", p * 4)
            cin = p * 4
    torch.save(sd, str(path))
    return str(path)


def port_init_for_jax(monkeypatch, cls, variables):
    """Hand flax module class `cls` the port's init: its `init` returns
    `variables`, so the JAX driver compiles no init and both packages
    start from one point."""
    monkeypatch.setattr(cls, "init", lambda self, *a, **k: variables)


def test_resnet_embed_fn_matches_jax(tmp_path, monkeypatch):
    from reid_tpu.models import baseline as jbaseline
    from reid_tpu_torch.models.baseline import ResNetReID

    path = resnet50_state_dict(tmp_path / "r50.pt")
    port_init_for_jax(monkeypatch, jbaseline.ResNetReID, flax_variables(
        ResNetReID(num_classes=1, block="bottleneck", blocks=(3, 4, 6, 3),
                   bottleneck_dim=0).init_weights(
                       torch.Generator().manual_seed(0))))
    imgs = np.random.default_rng(8).uniform(-1, 1, (4, 64, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jgan.make_resnet_embed_fn(path))(
        jnp.asarray(imgs)))
    got = tgan.make_resnet_embed_fn(path, "cpu")(torch.from_numpy(imgs))
    assert got.shape == want.shape == (4, 2048)
    close(got, want, 1e-4)


def test_train_lsro_baseline_matches_jax(monkeypatch):
    from reid_tpu.models import baseline as jbaseline
    from reid_tpu_torch.models import build_model

    rng = np.random.default_rng(9)
    real = rng.integers(0, 255, (8, 64, 32, 3)).astype(np.uint8)
    gen = rng.integers(0, 255, (4, 64, 32, 3)).astype(np.uint8)
    labels = np.asarray([0, 1, 2, 3] * 2)
    kw = dict(num_classes=4, epochs=1, batch_size=4, lr=1e-3, seed=0,
              log_fn=lambda *_: None)
    # the port's driver builds its model from a generator seeded `seed`
    port_init_for_jax(monkeypatch, jbaseline.ResNetReID, flax_variables(
        build_model("baseline", 4, device="cpu",
                    generator=torch.Generator().manual_seed(0))))
    jstate, jhist = jgan.train_lsro_baseline(real, labels, gen, **kw)
    tvars, thist = tgan.train_lsro_baseline(real, labels, gen, device="cpu",
                                            **kw)
    assert len(thist) == len(jhist) == 1
    assert abs(thist[0]["loss"] - jhist[0]["loss"]) <= 1e-4 * abs(
        jhist[0]["loss"]), (thist, jhist)
    assert thist[0]["acc"] == jhist[0]["acc"]
    assert set(flatten(tvars["params"])) == set(flatten(tree(
        jstate["params"])))


@pytest.fixture(scope="module")
def tiny_market(tmp_path_factory):
    from reid_tpu_torch.data.datasets import write_synthetic_tree
    return write_synthetic_tree(str(tmp_path_factory.mktemp("market")),
                                "market1501", 4, 4, 128, 64,
                                gallery_per_id=2)


def test_gan_main_dcgan_runs(tiny_market, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out, ckpt = str(tmp_path / "gen"), str(tmp_path / "ckpt")
    imgs = cli.gan_main(["--root", tiny_market, "--bs", "4", "--epochs", "1",
                         "--nz", "8", "--ngf", "4", "--ndf", "4",
                         "--groups", "2", "--n_images", "5", "--out", out,
                         "--ckpt_dir", ckpt], device="cpu")
    assert imgs.shape == (5, 128, 64, 3) and np.isfinite(imgs).all()
    assert len(glob.glob(os.path.join(out, "gen_*.jpg"))) == 5
    paths = sorted(glob.glob(os.path.join(ckpt, "gan_group*.npz")))
    assert paths, "no group checkpoint"
    state = tdrv.load_gan_state(paths[0], nz=8, ngf=4, ndf=4, device="cpu")
    assert state.step > 0
    # the round trip: what was saved reads back unchanged
    again = str(tmp_path / "again.npz")
    tdrv.save_gan_state(again, state)
    a, b = np.load(paths[0]), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_gan_main_vae_and_lsro_main_run(tiny_market, tmp_path):
    out = str(tmp_path / "gen")
    imgs = cli.gan_main(["--root", tiny_market, "--bs", "24", "--epochs",
                         "1", "--vae", "--wasserstein", "--n_images", "3",
                         "--out", out], device="cpu")
    assert imgs.shape == (3, 128, 64, 3) and np.isfinite(imgs).all()
    ckpt = str(tmp_path / "lsro.npz")
    variables, hist = cli.lsro_main(["--root", tiny_market, "--gen_dir", out,
                                     "--bs", "8", "--epochs", "1",
                                     "--ckpt", ckpt], device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert 0.0 <= hist[0]["acc"] <= 1.0
    from reid_tpu_torch.utils.flax_bridge import load_npz
    hold_tree(load_npz(ckpt)["params"], variables["params"], 0.0)
    with pytest.raises(SystemExit):
        cli.lsro_main(["--root", tiny_market, "--gen_dir",
                       str(tmp_path)], device="cpu")


def test_cli_flags_match_jax(tiny_market, tmp_path, monkeypatch):
    """Both packages' gan_main and lsro_main pass the same arguments to
    their drivers, defaults and flags alike."""
    import reid_tpu.cli as jcli
    seen = {}

    def recorder(tag, result):
        # the port's sampler reads G's width from the state, not from ngf
        def record(*a, **k):
            seen.setdefault(tag, []).append(
                (tuple(np.shape(x) for x in a),
                 {n: v for n, v in k.items() if n != "device" and not (
                     n == "ngf" and result is samples)}))
            return result
        return record
    samples = np.zeros((1000, *IMG), np.float32)
    gen_dir = tmp_path / "g"
    gen_dir.mkdir()
    from PIL import Image
    Image.fromarray(np.zeros((128, 64, 3), np.uint8)).save(
        gen_dir / "gen_00000.jpg")
    for pkg, tag in ((jgan, "jax"), (tgan, "torch")):
        monkeypatch.setattr(pkg, "train_gan_groups",
                            recorder(tag, (None, [None])))
        monkeypatch.setattr(pkg, "generate_group_images",
                            recorder(tag, samples))
        monkeypatch.setattr(pkg, "train_lsro_baseline", recorder(
            tag, ({}, [{"loss": 0.0, "acc": 0.0}])))
    monkeypatch.chdir(tmp_path)
    for main in (jcli.gan_main, cli.gan_main):
        main(["--root", tiny_market, "--n_images", "2", "--out",
              str(tmp_path / "o")])
    for main in (jcli.lsro_main, cli.lsro_main):
        main(["--root", tiny_market, "--gen_dir", str(gen_dir)])
    assert seen["jax"] == seen["torch"] and len(seen["jax"]) == 3
