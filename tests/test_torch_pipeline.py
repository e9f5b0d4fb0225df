"""The port's crop and chunked tracking path against the JAX package:
`crop_resize_bilinear` within atol 1e-4 (f32 products summed in another
order), and the chunked tracker's outputs equal to JAX's - ids and valid
identical, tlwh within 1e-3 px - with chunk 1 and 8, with the crop cap and
budget, and with the appearance cadence, given the same embed function."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from _scenes import build_mot_scene  # noqa: E402

from reid_tpu.tracking import pipeline as jp  # noqa: E402
from reid_tpu.tracking.methods import method_config as jmc  # noqa: E402
from reid_tpu.tracking.tracker import init_tracker_state  # noqa: E402
from reid_tpu_torch.tracking import pipeline as tp  # noqa: E402
from reid_tpu_torch.tracking.methods import method_config as tmc  # noqa
from reid_tpu_torch.tracking.tracker import init_tracker_state as tinit  # noqa

CROP = (32, 16)
PROJ = np.random.default_rng(3).normal(size=(3 * 4 * 4, 24)).astype(
    np.float32)


def jax_embed(params, batch_stats, crops):
    n = crops.shape[0]
    pooled = crops.astype(jnp.float32).reshape(n, 4, 8, 4, 4, 3).mean(
        axis=(2, 4)).reshape(n, -1)
    f = pooled @ jnp.asarray(PROJ)
    return f / jnp.maximum(jnp.linalg.norm(f, axis=1, keepdims=True), 1e-12)


def torch_embed(crops):
    n = crops.shape[0]
    pooled = crops.to(torch.float32).reshape(n, 4, 8, 4, 4, 3).mean(
        dim=(2, 4)).reshape(n, -1)
    f = pooled @ torch.from_numpy(PROJ)
    return f / torch.clamp(torch.linalg.norm(f, dim=1, keepdim=True),
                           min=1e-12)


@pytest.mark.parametrize("hw,n", [((240, 320), 7), ((120, 64), 5)])
def test_crop_resize_matches_jax(hw, n):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (*hw, 3)).astype(np.float32) / 255.0
    boxes = np.concatenate([rng.uniform(-10, hw[1] - 20, (n, 1)),
                            rng.uniform(-10, hw[0] - 40, (n, 1)),
                            rng.uniform(5, 60, (n, 1)),
                            rng.uniform(10, 120, (n, 1))], 1).astype(
        np.float32)
    for ch, cw in ((64, 32), (16, 48)):
        for ds in (1, 2):
            want = jp.crop_resize_bilinear(jnp.asarray(img),
                                           jnp.asarray(boxes), ch, cw, ds)
            got = tp.crop_resize_bilinear(torch.from_numpy(img),
                                          torch.from_numpy(boxes), ch, cw, ds)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4)


def test_resize_matches_jax_image_resize():
    x = np.random.default_rng(1).random((23, 17, 3)).astype(np.float32)
    for out in ((23, 17), (40, 9), (11, 30)):
        want = jax.image.resize(jnp.asarray(x), (*out, 3), "bilinear")
        got = tp.resize_bilinear_matmul(torch.from_numpy(x), out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("chunk,cap,budget,k", [(1, None, None, 1),
                                                (8, None, None, 1),
                                                (8, 4, 20, 1),
                                                (8, None, None, 2)])
def test_chunked_tracker_matches_jax(chunk, cap, budget, k):
    frames, tlwh, conf, valid, _ = build_mot_scene(
        t_total=16, n_t=5, max_dets=8, h=120, w=160, seed=4)
    kw = dict(max_tracks=16, max_dets=8, crop_hw=CROP, embed_every=k)
    jrun = jp.make_chunked_tracker(jmc("strongsort", **kw), jax_embed, CROP,
                                   chunk=chunk, crop_budget=budget,
                                   frame_crop_cap=cap)
    trun = tp.make_chunked_tracker(tmc("strongsort", **kw), torch_embed,
                                   CROP, chunk=chunk, crop_budget=budget,
                                   frame_crop_cap=cap)
    js = init_tracker_state(16, 24)
    ts = tinit(16, 24, device="cpu")
    for s in range(0, 16, chunk):
        sl = slice(s, s + chunk)
        js, jo = jrun({}, {}, js, jnp.asarray(frames[sl]),
                      jnp.asarray(tlwh[sl]), jnp.asarray(conf[sl]),
                      jnp.asarray(valid[sl]))
        ts, to = trun(ts, torch.from_numpy(frames[sl]),
                      torch.from_numpy(tlwh[sl]), torch.from_numpy(conf[sl]),
                      torch.from_numpy(valid[sl]))
        v = np.asarray(jo["valid"])
        np.testing.assert_array_equal(to["valid"].numpy(), v)
        np.testing.assert_array_equal(to["ids"].numpy(), np.asarray(jo["ids"]))
        np.testing.assert_allclose(to["tlwh"].numpy()[v],
                                   np.asarray(jo["tlwh"])[v], atol=1e-3)
    assert int(ts.next_id) > 3
