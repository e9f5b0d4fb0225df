"""The port's tracker against the JAX tracker frame by frame, on a shared
synthetic MOT scene with the same numpy features: every method, both
appearance cadences, and the non-default assignments.

Tolerance: ids and valid flags identical on every frame; tlwh within
1e-3 px (f32 with a different summation order in the Kalman solves)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from _scenes import build_mot_scene  # noqa: E402

from reid_tpu.tracking.methods import method_config as jmc  # noqa: E402
from reid_tpu.tracking.tracker import Tracker as JTracker  # noqa: E402
from reid_tpu_torch.tracking.methods import method_config as tmc  # noqa
from reid_tpu_torch.tracking.tracker import Tracker as TTracker  # noqa

FEAT = 32


def scene_with_features(seed=0, t_total=16, n_t=6, max_dets=8):
    frames, tlwh, conf, valid, gt = build_mot_scene(
        t_total=t_total, n_t=n_t, max_dets=max_dets, h=240, w=320,
        seed=seed)
    rng = np.random.default_rng(seed + 100)
    base = rng.normal(size=(n_t, FEAT))
    feats = rng.normal(size=(t_total, max_dets, FEAT)) * 0.3
    for t in range(t_total):
        boxes, ids = gt[t + 1]
        gc = boxes[:, :2] + boxes[:, 2:] / 2
        for j in np.flatnonzero(valid[t]):
            c = tlwh[t, j, :2] + tlwh[t, j, 2:] / 2
            k = np.argmin(np.linalg.norm(gc - c, axis=1))
            if np.linalg.norm(gc[k] - c) < 20:
                feats[t, j] += base[ids[k]]
    return tlwh, conf, valid, feats.astype(np.float32)


CASES = ([(m, k, "greedy_rounds") for m in
          ["strongsort", "deepocsort", "ocsort", "bytetrack", "botsort"]
          for k in (1, 2)]
         + [("strongsort", 1, "greedy"), ("strongsort", 1, "auction")])


@pytest.mark.parametrize("method,embed_every,assignment", CASES)
def test_tracker_matches_jax(method, embed_every, assignment):
    tlwh, conf, valid, feats = scene_with_features()
    kw = dict(max_tracks=16, max_dets=8, embed_every=embed_every,
              assignment=assignment, gmc=False)
    jt = JTracker(jmc(method, **kw), feat_dim=FEAT)
    tt = TTracker(tmc(method, **kw), feat_dim=FEAT, device="cpu")
    js, ts = jt.init_state(), tt.init_state()
    n_valid = 0
    for t in range(tlwh.shape[0]):
        hf = t % embed_every == 0
        f = feats[t] if hf else np.zeros_like(feats[t])
        js, jo = jt.update(js, jnp.asarray(tlwh[t]), jnp.asarray(conf[t]),
                           jnp.asarray(f), jnp.asarray(valid[t]),
                           has_feats=hf)
        ts, to = tt.update(ts, torch.from_numpy(tlwh[t]),
                           torch.from_numpy(conf[t]), torch.from_numpy(f),
                           torch.from_numpy(valid[t]), has_feats=hf)
        np.testing.assert_array_equal(to["valid"].numpy(),
                                      np.asarray(jo["valid"]), err_msg=t)
        np.testing.assert_array_equal(to["ids"].numpy(),
                                      np.asarray(jo["ids"]), err_msg=t)
        v = np.asarray(jo["valid"])
        np.testing.assert_allclose(to["tlwh"].numpy()[v],
                                   np.asarray(jo["tlwh"])[v], atol=1e-3)
        np.testing.assert_array_equal(ts.status.numpy(),
                                      np.asarray(js.status))
        n_valid += int(v.sum())
    assert n_valid > 20          # the scene really exercises the tracker
