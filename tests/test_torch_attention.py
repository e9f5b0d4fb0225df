"""The SERes18 family's block attentions and the norms of
`reid_tpu/models/layers.py` that the port added with them, against the JAX
package's flax modules on numpy inputs from a seed.

  * `TripletAttention` and `EMAttention` alone (random gate statistics and
    conv biases): eval mode in f32 within 1e-5 of the output's largest
    magnitude; eval mode in bf16 bit-equal to the jitted flax module; train
    mode in f32 (the gate BatchNorms on batch statistics, momentum 0.99):
    the output within 1e-5 of its largest magnitude, the gate statistics
    after the call within 1e-5 of theirs, and the gradient of a random
    linear function of the output with respect to the input and to the
    parameters within 1e-4 of its L2 norm.
  * `SEBasicBlock(attention="triplet" | "ema")` in bf16, eval mode,
    bit-equal to the jitted flax block (IBN, plain, strided with a
    downsample), and with BatchRenorm norms.
  * `BatchRenorm` and `BatchRenormNonIID` (its ragged tail: 10 samples in
    groups of 4) from a state past warm-up (steps = 750, where r_max = 2
    and d_max = 2.5) whose running statistics lie far from the batch's, so
    that r and d clip: train-mode output, new statistics and `steps`, and
    gradients (input, scale, bias) as above; eval mode in f32 within 1e-5
    and in bf16 bit-equal. A fresh BatchRenorm (steps = 0) normalizes with
    the plain batch statistics (r = 1, d = 0). `IBN(renorm=True)`, `LBN1D`
    (renorm and not), `MetaAconC1D` and `AttentionPooling` in f32, train
    and eval mode, within 1e-5.

The train-mode inputs hold enough values a channel (at least 96) that
flax's fast variance does not cancel (test_torch_train_step.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.models import layers as jl
from reid_tpu.models.ema_attention import EMAttention as JEMA
from reid_tpu.models.seres18 import SEBasicBlock as JBlock
from reid_tpu.models.triplet_attention import TripletAttention as JTriplet
from reid_tpu_torch.models import layers as tl
from reid_tpu_torch.models.ema_attention import EMAttention
from reid_tpu_torch.models.seres18 import SEBasicBlock
from reid_tpu_torch.models.triplet_attention import TripletAttention
from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              torch_state_dict)
from test_torch_models import _random_stats
from test_torch_train_data import two_torch_threads  # noqa: F401

tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731


def close(got, want, share):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= share * scale, (err, scale)


def randomize(v, seed):
    """Random running statistics (BatchRenorm's `steps` kept) and random
    biases (zero at init)."""
    rng = np.random.default_rng(seed)
    v = tree(v)

    def walk(node, new=None):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x, None if new is None else new[k])
            elif k == "bias" and new is None:
                node[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            elif k == "steps" and new is not None:
                new[k] = x
    if "batch_stats" in v:
        new = _random_stats(v["batch_stats"], rng)
        walk(v["batch_stats"], new)
        v["batch_stats"] = new
    walk(v["params"])
    return v


def flax_init(jm, x, seed=0, **kw):
    v = jax.jit(lambda k, xx: jm.init(k, xx, **kw))(
        jax.random.PRNGKey(seed), jnp.asarray(x))
    return randomize(v, seed + 1)


def flax_eval(jm, v, x, dtype, **kw):
    out = jax.jit(lambda vv, xx: jm.apply(vv, xx.astype(dtype), **kw))(
        v, jnp.asarray(x))
    return np.asarray(out, np.float32)


def port_eval(pm, v, x, dtype, **kw):
    load_flax_variables(pm, v)
    with torch.no_grad():
        return pm(torch.from_numpy(x).to(dtype), **kw).float().numpy()


ATTENTIONS = {
    "triplet": (lambda dt: JTriplet(dtype=dt),
                lambda c, dt: TripletAttention(dt)),
    "ema": (lambda dt: JEMA(dtype=dt), lambda c, dt: EMAttention(c, dtype=dt)),
}


def attention_input(c=64, seed=0):
    return np.random.default_rng(seed).normal(
        size=(2, 8, 6, c)).astype(np.float32)


@pytest.mark.parametrize("kind", list(ATTENTIONS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_eval_matches_flax(kind, dtype):
    jmake, tmake = ATTENTIONS[kind]
    x = attention_input()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    v = flax_init(jmake(jnp.float32), x, train=False)
    want = flax_eval(jmake(jdt), v, x, jdt, train=False)
    got = port_eval(tmake(64, tdt), v, x, tdt)
    assert np.abs(want - x).max() > 0.1
    if dtype == "float32":
        close(got, want, 1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(ATTENTIONS))
def test_attention_train_matches_flax(kind):
    jmake, tmake = ATTENTIONS[kind]
    x = attention_input(seed=1)
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jm = jmake(jnp.float32)
    v = flax_init(jm, x, train=False)
    stats = v.get("batch_stats", {})

    def f(p, xx):
        y, mut = jm.apply({"params": p, "batch_stats": stats}, xx,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut.get("batch_stats", {}))
    (gp, gx), (y_j, stats_j) = jax.jit(jax.grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))

    pm = tmake(64, torch.float32)
    load_flax_variables(pm, v)
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt, train=True)
    close(y.detach().numpy(), np.asarray(y_j), 1e-5)
    want_stats = torch_state_dict({"batch_stats": tree(stats_j)})
    if kind == "triplet":
        assert len(want_stats) == 6
        for gate in ("cw", "hc", "hw"):
            before = stats[gate]["bn"]["mean"]
            after = want_stats[f"{gate}.bn.running_mean"].numpy()
            assert np.abs(after - before).max() > 1e-4
    for name, buf in pm.named_buffers():
        close(buf.numpy(), want_stats[name].numpy(), 1e-5)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)),
                                [xt] + list(pm.parameters()))
    want_gx = np.asarray(gx, np.float64)
    err = np.linalg.norm(grads[0].double().numpy() - want_gx)
    assert err <= 1e-4 * np.linalg.norm(want_gx)
    want_gp = torch_state_dict({"params": tree(gp)})
    for name, g in zip(names, grads[1:]):
        want = want_gp[name].double()
        assert float((g.double() - want).norm()) <= \
            1e-4 * float(want.norm()) + 1e-12, name


BLOCKS = [(64, 64, 1, True, False), (32, 64, 2, True, True),
          (64, 64, 1, False, True)]


@pytest.mark.parametrize("attention", ["triplet", "ema"])
@pytest.mark.parametrize("cin,planes,stride,ibn,down", BLOCKS)
def test_attention_block_bf16_bit_equal_flax(attention, cin, planes, stride,
                                             ibn, down):
    x = np.random.default_rng(3).normal(size=(2, 8, 6, cin)).astype(
        np.float32)
    v = flax_init(JBlock(planes, strides=stride, ibn=ibn, downsample=down,
                         attention=attention), x, train=False)
    jm = JBlock(planes, strides=stride, ibn=ibn, downsample=down,
                attention=attention, dtype=jnp.bfloat16)
    want = flax_eval(jm, v, x, jnp.bfloat16, train=False)
    pm = SEBasicBlock(cin, planes, stride, ibn, down, torch.bfloat16,
                      attention)
    np.testing.assert_array_equal(port_eval(pm, v, x, torch.bfloat16), want)


@pytest.mark.parametrize("attention", ["se", "triplet"])
def test_renorm_block_bf16_bit_equal_flax(attention):
    """A renorm block (IBN with a BatchRenorm half, BatchRenorm bn2 and
    down_bn) in eval mode, with its `steps` carried."""
    x = np.random.default_rng(4).normal(size=(2, 8, 6, 32)).astype(
        np.float32)
    kw = dict(strides=2, ibn=True, downsample=True, attention=attention,
              renorm=True)
    v = flax_init(JBlock(64, **kw), x, train=False)
    assert "steps" in v["batch_stats"]["bn2"]
    want = flax_eval(JBlock(64, dtype=jnp.bfloat16, **kw), v, x,
                     jnp.bfloat16, train=False)
    pm = SEBasicBlock(32, 64, 2, True, True, torch.bfloat16, attention,
                      renorm=True)
    assert isinstance(pm.bn2, tl.BatchRenorm)
    assert isinstance(pm.bn1.BN, tl.BatchRenorm)
    np.testing.assert_array_equal(port_eval(pm, v, x, torch.bfloat16), want)


# BatchRenorm

def renorm_state(c, seed, steps=750):
    """Scale, bias and running statistics far from a unit batch's (mean
    ~N(1, 0.5), var ~U(0.05, 4)), `steps` past warm-up."""
    rng = np.random.default_rng(seed)
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            "batch_stats": {
                "mean": rng.normal(1, 0.5, c).astype(np.float32),
                "var": rng.uniform(0.05, 4.0, c).astype(np.float32),
                "steps": np.int32(steps)}}


def renorm_train_both(jm, pm, v, x):
    """Train-mode output, new statistics and gradients of a random linear
    function of the output, each framework: (y, stats, gx, gparams)."""
    r = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def f(p, xx):
        y, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          xx, use_running_average=False,
                          mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])
    (gp, gx), (y, stats) = jax.jit(jax.grad(f, argnums=(0, 1),
                                            has_aux=True))(
        v["params"], jnp.asarray(x))
    want = (np.asarray(y), torch_state_dict({"batch_stats": tree(stats)}),
            np.asarray(gx), torch_state_dict({"params": tree(gp)}))
    load_flax_variables(pm, v)
    xt = torch.from_numpy(x).requires_grad_()
    yt = pm(xt, train=True)
    gs = torch.autograd.grad(torch.sum(yt * torch.from_numpy(r)),
                             [xt, pm.weight, pm.bias])
    got = (yt.detach().numpy(), dict(pm.named_buffers()), gs[0].numpy(),
           {"weight": gs[1], "bias": gs[2]})
    return got, want


def check_train(got, want):
    close(got[0], want[0], 1e-5)
    for name, buf in got[1].items():
        if name == "steps":
            assert buf.dtype == torch.int32
            assert int(buf) == int(want[1][name]) == 751
        else:
            close(buf.numpy(), want[1][name].numpy(), 1e-5)
    assert np.linalg.norm(got[2] - want[2]) <= 1e-4 * np.linalg.norm(
        want[2])
    for name, g in got[3].items():
        w = want[3][name].double()
        assert float((g.double() - w).norm()) <= 1e-4 * float(w.norm())


def clipped(v, x, axes):
    """Whether r and d clip somewhere at steps = 750 (r_max 2, d_max
    2.5) for the batch statistics over `axes`."""
    mean, var = x.mean(axes), x.var(axes)
    ra_std = np.sqrt(v["batch_stats"]["var"] + 1e-5)
    r = np.sqrt(var + 1e-5) / ra_std
    d = (mean - v["batch_stats"]["mean"]) / ra_std
    return (r > 2).any() or (r < 0.5).any(), (np.abs(d) > 2.5).any()


def test_batch_renorm_train_past_warmup_matches_flax():
    c = 16
    x = np.random.default_rng(5).normal(size=(6, 6, 4, c)).astype(np.float32)
    x[..., :4] *= 3.0
    v = renorm_state(c, 0)
    assert clipped(v, x, (0, 1, 2)) == (True, True)
    got, want = renorm_train_both(jl.BatchRenorm(), tl.BatchRenorm(c), v, x)
    check_train(got, want)


def test_batch_renorm_fresh_is_batch_norm():
    """At steps = 0 the clip is shut: r = 1 and d = 0, so the output is the
    plain batch normalization (two-pass variance)."""
    c = 8
    x = np.random.default_rng(6).normal(2.0, 3.0, size=(4, 6, 4, c)).astype(
        np.float32)
    v = renorm_state(c, 1, steps=0)
    pm = tl.BatchRenorm(c)
    load_flax_variables(pm, v)
    y = pm(torch.from_numpy(x), train=True).detach().double().numpy()
    xd = x.astype(np.float64)
    plain = (xd - xd.mean((0, 1, 2))) / np.sqrt(xd.var((0, 1, 2)) + 1e-5)
    want = plain * v["params"]["scale"] + v["params"]["bias"]
    close(y, want, 1e-5)
    assert int(pm.steps) == 1


@pytest.mark.parametrize("b", [8, 10])
def test_batch_renorm_non_iid_train_matches_flax(b):
    """Groups of 4; at b = 10 two samples form the ragged tail."""
    c = 16
    x = np.random.default_rng(7).normal(size=(b, 6, 4, c)).astype(np.float32)
    x[:4] = x[:4] * 3.0 + 5.0
    v = renorm_state(c, 2)
    assert clipped(v, x[:4], (0, 1, 2)) == (True, True)
    got, want = renorm_train_both(jl.BatchRenormNonIID(),
                                  tl.BatchRenormNonIID(c), v, x)
    check_train(got, want)


@pytest.mark.parametrize("cls", ["BatchRenorm", "BatchRenormNonIID"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_renorm_eval_matches_flax(cls, dtype):
    c = 16
    x = np.random.default_rng(8).normal(size=(5, 6, 4, c)).astype(np.float32)
    v = renorm_state(c, 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = getattr(jl, cls)(dtype=jdt)
    want = flax_eval(jm, v, x, jdt, use_running_average=True)
    got = port_eval(getattr(tl, cls)(c, dtype=tdt), v, x, tdt)
    if dtype == "float32":
        close(got, want, 1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def apply_both(jm, pm, v, x, train, mutable=("batch_stats",)):
    """Each framework's output (and, in train mode, new statistics)."""
    kw = dict(train=train) if train is not None else {}
    if train:
        y, mut = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, mutable=list(mutable), **kw))(v, jnp.asarray(x))
        stats = torch_state_dict({"batch_stats": tree(mut["batch_stats"])})
    else:
        y, stats = jax.jit(lambda vv, xx: jm.apply(vv, xx, **kw))(
            v, jnp.asarray(x)), None
    load_flax_variables(pm, v)
    with torch.no_grad():
        yt = pm(torch.from_numpy(x), **kw)
    close(yt.numpy(), np.asarray(y), 1e-5)
    if train:
        for name, buf in pm.named_buffers():
            if name.endswith("steps"):
                assert int(buf) == int(stats[name])
            else:
                close(buf.numpy(), stats[name].numpy(), 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_ibn_renorm_matches_flax(train):
    c = 32
    x = np.random.default_rng(10).normal(1.0, 2.0, size=(4, 6, 4, c)).astype(
        np.float32)
    v = flax_init(jl.IBN(renorm=True), x, train=False)
    v["batch_stats"]["BN"]["steps"] = np.int32(750)
    pm = tl.IBN(c, renorm=True)
    assert isinstance(pm.BN, tl.BatchRenorm)
    apply_both(jl.IBN(renorm=True), pm, v, x, train)


@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_lbn1d_matches_flax(renorm, train):
    c = 32
    x = np.random.default_rng(11).normal(0.5, 2.0, size=(96, c)).astype(
        np.float32)
    v = flax_init(jl.LBN1D(renorm=renorm), x, train=False)
    apply_both(jl.LBN1D(renorm=renorm), tl.LBN1D(c, renorm=renorm), v, x,
               train)


@pytest.mark.parametrize("train", [False, True])
def test_meta_acon_c1d_matches_flax(train):
    width = 32
    x = np.random.default_rng(12).normal(size=(96, width)).astype(np.float32)
    v = flax_init(jl.MetaAconC1D(width=width), x, train=False)
    apply_both(jl.MetaAconC1D(width=width), tl.MetaAconC1D(width), v, x,
               train)


def test_attention_pooling_matches_flax():
    """The reference's own use (tests/test_augment_extra.py:62): (N, L, C)
    -> (N, C), 8 heads."""
    x = np.random.default_rng(13).normal(size=(3, 10, 64)).astype(np.float32)
    v = flax_init(jl.AttentionPooling(), x)
    pm = tl.AttentionPooling(64)
    apply_both(jl.AttentionPooling(), pm, v, x, None)
    # and the way back to flax naming
    got = flax_variables(pm)
    assert jax.tree_util.tree_map(np.shape, got["params"]) == \
        jax.tree_util.tree_map(np.shape, v["params"])
