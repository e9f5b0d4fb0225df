"""The small library modules of the port against the JAX package's:
`losses/circle.py`, `losses/ranked.py`, `train/extras.py` and
`utils/profiling.py`, on numpy inputs from a seed.

  * `circle_loss` and `ranked_loss` (both with and without the
    normalization): the value and the gradient with respect to the
    features within rtol 1e-5 of the jitted JAX function and `jax.grad`.
  * `mixup_apply` on JAX's own draws of `mixup_batch` (lambda and the
    permutation from its key): the mixed images and soft labels equal
    JAX's; `mixup_batch`'s draws from a `numpy.random.Generator`: lambda
    in [0, 1], a permutation, the shapes.
  * `model_size_mb` of SERes18 equals JAX's over the same bridged tree.
  * `redetection` on a stub detector equals JAX's image for image.
  * `plot_loss` writes its PNG where matplotlib imports and returns None
    where it does not, as JAX's does.
  * `trace` writes a torch.profiler trace that TensorBoard reads
    (`*.pt.trace.json`); `StageTimer` is `utils/timing.StageTimer`.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.train.extras as jx
from reid_tpu.losses import circle_loss as jcircle
from reid_tpu.losses import ranked_loss as jranked
from reid_tpu.models import build_model as jbuild
from reid_tpu_torch.losses import circle_loss, ranked_loss
from reid_tpu_torch.models import build_model
from reid_tpu_torch.train import extras as tx
from reid_tpu_torch.utils import profiling, timing
from reid_tpu_torch.utils.flax_bridge import flax_variables
from test_torch_train_data import two_torch_threads  # noqa: F401

RNG = np.random.default_rng(0)
LABELS = np.asarray([0, 0, 1, 1, 2, 2, 3, 1], np.int32)


def features(normed):
    x = RNG.normal(size=(8, 16)).astype(np.float32)
    if normed:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def value_and_grad_both(jfn, tfn, x):
    jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tv = tfn(xt)
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()))


def test_circle_loss_matches_jax():
    labels = torch.from_numpy(LABELS)
    value_and_grad_both(lambda f: jcircle(f, jnp.asarray(LABELS)),
                        lambda f: circle_loss(f, labels), features(True))


@pytest.mark.parametrize("normalize", [True, False])
def test_ranked_loss_matches_jax(normalize):
    labels = torch.from_numpy(LABELS)
    x = features(False) * (1.0 if normalize else 0.4)
    value_and_grad_both(
        lambda f: jranked(f, jnp.asarray(LABELS),
                          normalize_feature=normalize),
        lambda f: ranked_loss(f, labels, normalize_feature=normalize), x)


def test_mixup_matches_jax_draws():
    imgs = RNG.random((6, 8, 4, 3)).astype(np.float32)
    labels = np.asarray([0, 1, 2, 2, 1, 0], np.int32)
    key = jax.random.PRNGKey(3)
    want_x, want_y = jx.mixup_batch(key, jnp.asarray(imgs),
                                    jnp.asarray(labels), 3)
    k1, k2 = jax.random.split(key)
    lam = float(jax.random.beta(k1, 0.2, 0.2))
    perm = np.asarray(jax.random.permutation(k2, 6))
    got_x, got_y = tx.mixup_apply(torch.from_numpy(imgs),
                                  torch.from_numpy(labels), 3, lam, perm)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))

    rng = np.random.default_rng(5)
    mixed, soft = tx.mixup_batch(rng, torch.from_numpy(imgs),
                                 torch.from_numpy(labels), 3)
    again = np.random.default_rng(5)
    lam = again.beta(0.2, 0.2)
    perm = again.permutation(6)
    assert 0.0 <= lam <= 1.0 and sorted(perm) == list(range(6))
    assert mixed.shape == (6, 8, 4, 3) and soft.shape == (6, 3)
    np.testing.assert_allclose(soft.sum(1).numpy(), 1.0, rtol=1e-6)
    want = tx.mixup_apply(torch.from_numpy(imgs), torch.from_numpy(labels),
                          3, lam, perm)
    assert torch.equal(mixed, want[0]) and torch.equal(soft, want[1])


def test_model_size_matches_jax():
    """Over the port's model and over its bridged params tree, which is
    the flax init's (shapes from `jax.eval_shape`, nothing compiled)."""
    jm = jbuild("seres18", num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)), train=True))
    pm = build_model("seres18", num_classes=10, device="cpu")
    params = flax_variables(pm)["params"]
    assert jax.tree_util.tree_map(np.shape, params) == \
        jax.tree_util.tree_map(np.shape, shapes["params"])
    want = jx.model_size_mb(params)
    assert tx.model_size_mb(pm) == want == jx.model_size_mb(
        shapes["params"])
    assert 40.0 < want < 50.0


def test_redetection_matches_jax():
    imgs = RNG.integers(0, 256, (4, 48, 24, 3), dtype=np.uint8)

    def detector(images):
        return [(np.asarray([[2, 3, 10, 20], [5, 5, 12, 30.5]]),
                 np.asarray([0.3, 0.9])),
                (np.zeros((0, 4)), np.zeros((0,))),
                (np.asarray([[4, 8, 10, 10]]), np.asarray([0.2])),
                (np.asarray([[30, 60, 5, 5]]), np.asarray([0.8]))]
    want = jx.redetection(detector, imgs)
    got = tx.redetection(detector, imgs)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], imgs[0])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], imgs[i])


def test_plot_loss_as_jax(tmp_path):
    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    want = jx.plot_loss([3.0, 2.0, 1.5], str(tmp_path / "jax.png"))
    got = tx.plot_loss([3.0, 2.0, 1.5], str(tmp_path / "port" / "c.png"))
    assert (got is None) == (want is None) == (not have)
    if have:
        assert os.path.getsize(got) > 0


def test_trace_writes_a_trace(tmp_path):
    assert profiling.StageTimer is timing.StageTimer
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
