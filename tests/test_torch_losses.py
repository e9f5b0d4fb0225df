"""The port's losses (`reid_tpu_torch/losses/`) against the JAX package's
on the same numpy inputs: each loss's value and its gradient (autograd
against `jax.grad`) in f32, with and without per-sample weights; the DCC
table update against the JAX package's `lax.scan`, with classes repeated
in arbitrary batch order; the XBM ring's enqueue across its wrap.

Tolerance: values and gradients within rtol = 1e-5 and an atol of
2e-5 of the tensor's largest magnitude (at least 1e-6): f32 with sums in
another order, whose rounding scales with the largest term (the DCC
term's logits reach 160). The DCC tables within 1e-6; the XBM ring
exactly (a copy).

The XBM case holds exact copies of the batch in the memory, all at a
hundredth of the scale: the self-match rule (distance <= 1e-4) reads the
root of |x|^2 + |y|^2 - 2xy, which for a copy at unit scale is rounding
noise of ~1e-3 that each framework's summation order decides its own
way."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.config as jcfg
import reid_tpu.losses as jl
import reid_tpu_torch.config as tcfg
import reid_tpu_torch.losses as tl
from test_torch_train_data import two_torch_threads  # noqa: F401

B, D, C = 8, 16, 4
RTOL, ATOL = 1e-5, 1e-6


def assert_close(got, want):
    want = np.asarray(want)
    atol = max(ATOL, 2e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=atol)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, D)).astype(np.float32)
    logits = rng.normal(size=(B, C)).astype(np.float32) * 3
    labels = np.repeat(np.arange(C), B // C).astype(np.int32)
    rng.shuffle(labels)
    weights = rng.uniform(0, 1, B).astype(np.float32) / B
    return emb, logits, labels, weights


def tables(seed=1, n=C, d=C):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    return (a / np.linalg.norm(a, axis=1, keepdims=True),
            b / np.linalg.norm(b, axis=1, keepdims=True))


def memory(seed=2, k=2 * B):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(k, D)).astype(np.float32)
    labels = rng.integers(-1, C, k).astype(np.int32)
    return feats, labels


# name -> (jax fn, port fn) of (emb, logits, labels, weights-or-None);
# each returns a scalar
def _hybrid(lib, cfg_mod, margin, use_ce):
    def fn(emb, logits, labels, w, lib=lib):
        t = lib is tl
        cen = np.random.default_rng(3).normal(size=(C, D)).astype(np.float32)
        ccc, icc = tables()
        conv = torch.from_numpy if t else jnp.asarray
        state = lib.HybridLossState(
            centers=conv(cen), dcc=lib.DCCState(conv(ccc), conv(icc)))
        cfg = cfg_mod.LossConfig(margin=margin, use_ce=use_ce, epsilon=0.1,
                                 tao=2.0)
        return lib.hybrid_loss(state, emb, logits, labels, cfg,
                               weights=w)[0]
    return fn


def _with(lib, name, **kw):
    def fn(emb, logits, labels, w):
        if name == "triplet_beta_aug":
            return lib.triplet_beta(emb, labels, emb * 0.9 + 0.1, weights=w,
                                    **kw)
        f = getattr(lib, name)
        if name in ("cross_entropy_label_smooth",):
            return f(logits, labels, weights=w, **kw)
        if name in ("focal_loss", "label_smoothing_nll"):
            return f(logits, labels, **kw)
        if name == "center_loss":
            cen = np.random.default_rng(3).normal(size=(C, D)).astype(
                np.float32)
            conv = torch.from_numpy if lib is tl else jnp.asarray
            return f(emb, labels, conv(cen), weights=w)
        if name == "dcc_loss":
            conv = torch.from_numpy if lib is tl else jnp.asarray
            ccc, icc = tables()
            return f(logits, labels, lib.DCCState(conv(ccc), conv(icc)),
                     **kw)
        if name == "xbm_triplet_loss":
            conv = torch.from_numpy if lib is tl else jnp.asarray
            feats, mlabels = memory()
            # the batch's own enqueued copy fills the first B slots
            feats[:B], _, mlabels[:B], _ = inputs()
            feats *= 0.01
            state = lib.XBMState(conv(feats), conv(mlabels),
                                 0 if lib is tl else jnp.int32(0))
            return f(emb, labels, state, weights=w)
        if name == "semi_hard_triplet":
            return f(emb, labels, **kw)
        return f(emb, labels, weights=w, **kw)
    return fn


CASES = {
    "wrt": ("weighted_regularized_triplet", {}),
    "batch_hard": ("triplet_loss_batch_hard", {"margin": 0.3, "alpha": 0.1}),
    "batch_hard_smooth": ("triplet_loss_batch_hard", {"smooth": True}),
    "triplet_beta": ("triplet_beta", {"margin": 0.3, "beta": 0.2}),
    "triplet_beta_aug": ("triplet_beta_aug", {"margin": 0.3}),
    "semi_hard": ("semi_hard_triplet", {"margin": 0.5}),
    "center": ("center_loss", {}),
    "ce_smooth": ("cross_entropy_label_smooth", {"epsilon": 0.2,
                                                 "tao": 2.0}),
    "focal": ("focal_loss", {"epsilon": 0.1}),
    "nll_smooth": ("label_smoothing_nll", {"epsilon": 0.1}),
    "dcc": ("dcc_loss", {"scalar": 20.0, "weight": 0.25}),
    "xbm": ("xbm_triplet_loss", {}),
}
WEIGHTLESS = {"semi_hard", "focal", "nll_smooth", "dcc"}


def _fns(case):
    if case.startswith("hybrid"):
        margin, use_ce = {"hybrid_wrt": (0.0, False),
                          "hybrid_margin_ce": (0.3, True)}[case]
        return (_hybrid(jl, jcfg, margin, use_ce),
                _hybrid(tl, tcfg, margin, use_ce))
    name, kw = CASES[case]
    return _with(jl, name, **kw), _with(tl, name, **kw)


ALL = list(CASES) + ["hybrid_wrt", "hybrid_margin_ce"]


@pytest.mark.parametrize("case,weighted", [(c, False) for c in ALL] + [
    (c, True) for c in ALL if c not in WEIGHTLESS])
def test_loss_and_gradient_match_jax(case, weighted):
    emb, logits, labels, weights = inputs()
    if case == "xbm":
        emb = emb * 0.01
    jfn, tfn = _fns(case)
    w = weights if weighted else None

    def jloss(e, lg):
        return jfn(e, lg, jnp.asarray(labels),
                   None if w is None else jnp.asarray(w))
    want, (ge_j, gl_j) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(logits))
    e = torch.from_numpy(emb).requires_grad_()
    lg = torch.from_numpy(logits).requires_grad_()
    got = tfn(e, lg, torch.from_numpy(labels),
              None if w is None else torch.from_numpy(w))
    ge_t, gl_t = torch.autograd.grad(got, (e, lg), allow_unused=True,
                                     materialize_grads=True)
    assert_close(got.item(), float(want))
    assert_close(ge_t.numpy(), ge_j)
    assert_close(gl_t.numpy(), gl_j)
    assert np.abs(np.asarray(ge_j)).max() + np.abs(np.asarray(gl_j)).max() \
        > 0


def test_center_gradient_reaches_centers():
    """The centers are trained: their gradient equals JAX's."""
    emb, _, labels, weights = inputs(4)
    cen = np.random.default_rng(5).normal(size=(C, D)).astype(np.float32)
    want = jax.grad(lambda c: jl.center_loss(
        jnp.asarray(emb), jnp.asarray(labels), c, jnp.asarray(weights)))(
            jnp.asarray(cen))
    c = torch.from_numpy(cen).requires_grad_()
    tl.center_loss(torch.from_numpy(emb), torch.from_numpy(labels), c,
                   torch.from_numpy(weights)).backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("rounds", [None, "bound"])
def test_update_dcc_luts_matches_scan(rounds):
    """Classes repeated 1-5 times in an arbitrary order, one class absent:
    the round-per-rank update equals the JAX package's per-instance scan,
    with the rounds read from the labels or given as the largest count."""
    rng = np.random.default_rng(6)
    n_cls, dim = 6, 6
    labels = np.asarray([0, 3, 3, 1, 0, 3, 4, 3, 0, 3, 1, 4], np.int32)
    rng.shuffle(labels)
    x = rng.normal(size=(len(labels), dim)).astype(np.float32) * 2
    ccc, icc = tables(7, n_cls, dim)
    want = jl.update_dcc_luts(jl.DCCState(jnp.asarray(ccc), jnp.asarray(icc)),
                              jnp.asarray(x), jnp.asarray(labels),
                              momentum=0.3)
    got = tl.update_dcc_luts(
        tl.DCCState(torch.from_numpy(ccc), torch.from_numpy(icc)),
        torch.from_numpy(x), torch.from_numpy(labels), momentum=0.3,
        rounds=None if rounds is None else 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    # the absent class keeps its rows; a present one moves
    np.testing.assert_array_equal(got.lut_icc[2].numpy(), icc[2])
    assert not np.allclose(got.lut_icc[3].numpy(), icc[3])
    np.testing.assert_array_equal(
        tl.dcc.class_ranks(torch.from_numpy(labels)).numpy(),
        [np.sum(labels[:i] == labels[i]) for i in range(len(labels))])


def test_xbm_enqueue_wraps_like_jax():
    """K = 12, batches of 4 then 8: the second write wraps to the ring's
    start; feats, labels and pointer equal the JAX package's."""
    k = 12
    js, ts = jl.init_xbm(k, D), tl.init_xbm(k, D, device="cpu")
    rng = np.random.default_rng(8)
    for b in (4, 8, 4, 8):
        f = rng.normal(size=(b, D)).astype(np.float32)
        lab = rng.integers(0, C, b).astype(np.int32)
        js = jl.xbm_enqueue(js, jnp.asarray(f), jnp.asarray(lab))
        ts = tl.xbm_enqueue(ts, torch.from_numpy(f), torch.from_numpy(lab))
        np.testing.assert_array_equal(ts.feats.numpy(), np.asarray(js.feats))
        np.testing.assert_array_equal(ts.labels.numpy(),
                                      np.asarray(js.labels))
        assert ts.ptr == int(js.ptr)
    assert ts.ptr == 0 and (ts.labels.numpy() >= 0).all()


@pytest.mark.parametrize("fn", ["euclidean_dist", "cosine_dist"])
def test_distances_match_jax(fn):
    emb, _, _, _ = inputs(9)
    y = emb[::-1].copy() * 0.5
    want = getattr(jl, fn)(jnp.asarray(emb), jnp.asarray(y))
    got = getattr(tl, fn)(torch.from_numpy(emb), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_loss_config_equals_jax():
    assert dataclasses.asdict(tcfg.LossConfig()) == dataclasses.asdict(
        jcfg.LossConfig())
