"""CenterNetLite training in the port (`models/detector.py` in train mode,
`make_centernet_targets`, `detection_loss`, `train/detector_train.py:
train_detector`) against the JAX package's, base 8 at 64x128, in f32,
with the flax init crossing through the bridge.

  * `make_centernet_targets` on padded boxes (invalid slots, a box at the
    frame's edge, two boxes on one cell): the size, offset and mask
    targets bit-equal, the heatmap's zeros equal and each value within
    an ulp (XLA:CPU's exp is its own approximation, within an ulp of
    torch's; XLA flushes subnormal results to 0, and so does the port);
  * `detection_loss` on random heads and those targets: rtol 1e-5;
  * the train-mode forward and the batch statistics it folds into the
    running ones (momentum 0.9, flax's biased variance): rtol = atol =
    1e-5 of each output's largest magnitude;
  * `train_detector` for two epochs of two batches of 4 frames (96x160
    resized to 64x128 on the device), the port's init handed JAX's: the
    mean loss of each epoch within 1e-4 relative, and the trained
    batch statistics within 1e-3 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.models import detector as jdet
from reid_tpu.train import detector_train as jdt
from reid_tpu_torch.models import detector as tdet
from reid_tpu_torch.train import detector_train as tdt
from reid_tpu_torch.utils.flax_bridge import (flatten, flax_variables,
                                              load_flax_variables)
from test_torch_attention import close, tree
from test_torch_train_data import two_torch_threads  # noqa: F401

HW = (64, 128)
FRAME_HW = (96, 160)


def boxes(rng, b=3, d=6, hw=HW):
    """Padded boxes (B, D, 4) tlwh and valid (B, D): random boxes, two
    invalid slots, a box past the right edge, and two boxes whose centres
    share a stride-4 cell (the later one's targets stay)."""
    h, w = hw
    wh = rng.uniform(6, 30, (b, d, 2))
    xy = rng.uniform(0, 1, (b, d, 2)) * (np.asarray([w, h]) - wh)
    tlwh = np.concatenate([xy, wh], -1).astype(np.float32)
    valid = np.ones((b, d), bool)
    valid[0, 4:] = False
    valid[2, 1] = False
    tlwh[1, 0] = [w - 4, 10, 12, 20]
    tlwh[1, 2] = tlwh[1, 1] + np.asarray([0.5, 0.25, 0, 0], np.float32)
    return tlwh, valid


def test_targets_match_jax():
    tlwh, valid = boxes(np.random.default_rng(0))
    want = jax.jit(lambda t, v: jdet.make_centernet_targets(t, v, HW))(
        jnp.asarray(tlwh), jnp.asarray(valid))
    got = tdet.make_centernet_targets(torch.from_numpy(tlwh),
                                      torch.from_numpy(valid), HW)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the splats' exp: torch's is within an ulp of XLA:CPU's fast exp
    heat, want_heat = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_array_equal(heat == 0, want_heat == 0)
    ulps = np.abs(heat.view(np.int32).astype(np.int64)
                  - want_heat.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    assert got[3].sum() == valid.sum() - 1       # one shared cell


def test_detection_loss_matches_jax():
    rng = np.random.default_rng(1)
    tlwh, valid = boxes(rng)
    targets = jdet.make_centernet_targets(jnp.asarray(tlwh),
                                          jnp.asarray(valid), HW)
    h, w = HW[0] // 4, HW[1] // 4
    out = {"heat": rng.normal(-2, 1.5, (3, h, w, 1)),
           "wh": rng.uniform(0, 8, (3, h, w, 2)),
           "offset": rng.uniform(0, 1, (3, h, w, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    want = float(jax.jit(jdet.detection_loss)(
        {k: jnp.asarray(v) for k, v in out.items()}, *targets))
    got = float(tdet.detection_loss(
        {k: torch.from_numpy(v) for k, v in out.items()},
        *(torch.from_numpy(np.asarray(t)) for t in targets)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.fixture(scope="module")
def flax_init():
    fm = jdet.CenterNetLite(base=8)
    v = jax.jit(lambda k, x: fm.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, *HW, 3)))
    return fm, tree(v)


def test_train_forward_matches_flax(flax_init):
    fm, v = flax_init
    x = np.random.default_rng(2).random((4, *HW, 3), dtype=np.float32)
    out, mut = jax.jit(lambda vv, xx: fm.apply(
        vv, xx, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = tdet.CenterNetLite(base=8)
    load_flax_variables(tm, v)
    got = tm(torch.from_numpy(x), train=True)
    for key in ("heat", "wh", "offset"):
        close(got[key].detach(), out[key], 1e-5)
    want = flatten(tree(mut["batch_stats"]))
    have = flatten(flax_variables(tm)["batch_stats"])
    assert set(want) == set(have)
    for k in want:
        close(have[k], want[k], 1e-5)


@pytest.fixture(scope="module")
def detector_data():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (8, *FRAME_HW, 3), np.uint8)
    tlwh, valid = boxes(rng, b=8, d=5, hw=FRAME_HW)
    for f, bs, vs in zip(frames, tlwh, valid):    # bright boxes to find
        for (x, y, w, h), ok in zip(bs.astype(int), vs):
            if ok:
                f[y:y + h, x:x + w] = 230
    return frames, tlwh, valid


def test_train_detector_matches_jax(flax_init, detector_data, monkeypatch):
    _, v = flax_init
    kw = dict(det_hw=HW, epochs=2, batch_size=4, lr=1e-3, base=8, seed=0,
              log_fn=lambda *_: None)
    _, jvars, jlosses = jdt.train_detector(*detector_data, **kw)

    class FromFlax(tdet.CenterNetLite):
        def init_weights(self, generator):
            load_flax_variables(self, v)
            return self
    monkeypatch.setattr(tdt, "CenterNetLite", FromFlax)
    model, tvars, tlosses = tdt.train_detector(*detector_data, device="cpu",
                                               **kw)
    assert len(tlosses) == len(jlosses) == 2
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    want = flatten(tree(jvars["batch_stats"]))
    have = flatten(tvars["batch_stats"])
    for k in want:
        close(have[k], want[k], 1e-3)
