"""The port's CenterNetLite, `decode_detections` and `make_detector_fn`
against the JAX package's, base 8 at 64x96, with the same flax variables
(bridged; the batch statistics moved off their init).

Tolerances:
  * the forward in f32: rtol = atol = 1e-4 (the convolutions sum in
    another order);
  * in bf16: every element within 2^-6 of the largest, cosine >= 0.9999
    (the standard of test_seres18_matches_flax[bfloat16]);
  * `decode_detections`: the same peaks in the same order, boxes and
    scores rtol 1e-6;
  * the detector function (f32, as the CLI builds it): the same valid
    slots, conf within 1e-6, boxes within 1e-3 px.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reid_tpu.models.detector import CenterNetLite as JCenterNet
from reid_tpu.models.detector import decode_detections as jdecode
from reid_tpu.train.detector_train import make_detector_fn as jmake
from reid_tpu_torch.models.detector import CenterNetLite, decode_detections
from reid_tpu_torch.train.detector_train import make_detector_fn
from reid_tpu_torch.utils.flax_bridge import load_flax_variables

from test_torch_yolo import assert_bf16_close, perturb_stats  # noqa: E402
from test_torch_train_data import two_torch_threads  # noqa: E402,F401

HW = (64, 96)


def pair(dtype_j, dtype_t):
    fm = JCenterNet(base=8, dtype=dtype_j)
    v = jax.jit(lambda k, x: fm.init(k, x, train=True))(
        jax.random.PRNGKey(1), jnp.zeros((1, *HW, 3)))
    v = perturb_stats(jax.tree_util.tree_map(np.asarray, v))
    tm = CenterNetLite(base=8, dtype=dtype_t)
    load_flax_variables(tm, v)
    return fm, v, tm.eval()


@pytest.fixture(scope="module")
def f32_pair():
    return pair(jnp.float32, torch.float32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_centernet_matches_flax(dt, f32_pair):
    fm, v, tm = f32_pair if dt == "float32" else pair(jnp.bfloat16,
                                                      torch.bfloat16)
    x = np.random.default_rng(0).random((2, *HW, 3), dtype=np.float32)
    want = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for key in ("heat", "wh", "offset"):
        g, w = got[key].float().numpy(), np.asarray(want[key], np.float32)
        assert g.shape == w.shape == (2, HW[0] // 4, HW[1] // 4,
                                      1 if key == "heat" else 2)
        if dt == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert_bf16_close(g, w)


def test_transposed_conv_matches_flax():
    """flax ConvTranspose(k=4, s=2, "SAME"), no kernel flip: the port's
    flipped weight, padding and crop give the same map, and the SAME
    pads are lax's (2, 2) for k=4, s=2 and (2, 1) for k=3, s=2."""
    import flax.linen as nn

    from reid_tpu_torch.models.layers import (ConvTranspose2d,
                                              conv_transpose_same_pads)
    assert conv_transpose_same_pads(4, 2) == (2, 2)
    assert conv_transpose_same_pads(3, 2) == (2, 1)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    for k in (3, 4):
        m = nn.ConvTranspose(4, (k, k), strides=(2, 2), padding="SAME")
        v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
        v = jax.tree_util.tree_map(np.asarray, v)
        v["params"]["bias"] = rng.normal(size=4).astype(np.float32)
        want = np.asarray(m.apply(v, jnp.asarray(x)))
        tm = ConvTranspose2d(6, 4, k, 2)
        load_flax_variables(tm, v)
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 10, 14, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_detections_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 16, 24
    heat = rng.normal(size=(2, h, w, 1)).astype(np.float32) * 2
    heat[:, 3, 4, 0] = heat[:, 9, 10, 0] = 5.0      # equal peaks: a tie
    out = {"heat": heat,
           "wh": rng.uniform(2, 20, (2, h, w, 2)).astype(np.float32),
           "offset": rng.uniform(0, 1, (2, h, w, 2)).astype(np.float32)}
    tj, sj = jdecode({k: jnp.asarray(a) for k, a in out.items()},
                     max_dets=20)
    tt, st = decode_detections({k: torch.from_numpy(a)
                                for k, a in out.items()}, max_dets=20)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("frame_hw", [(120, 160), (90, 200)])
def test_detector_fn_matches_jax(frame_hw, f32_pair):
    fm, v, tm = f32_pair
    frame = np.random.default_rng(3).integers(0, 256, (*frame_hw, 3),
                                              np.uint8)
    tj, cj, vj = jmake(fm, v, HW, max_dets=16, min_conf=0.1)(frame)
    tt, ct, vt = make_detector_fn(tm, HW, max_dets=16, min_conf=0.1)(frame)
    assert tt.shape == (16, 4) and vt.dtype == np.bool_
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(ct, cj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-3)
