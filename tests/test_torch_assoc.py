"""The port's association core against the JAX package: TrackerConfig,
Kalman filter, cost matrices and assignment, on the same numpy inputs.

Tolerances: matches are identical (ties to the first index, as `argmin`);
Kalman means and covariances agree to rtol 1e-5 (f32, different summation
order in the 4x4 solves), with an absolute floor of 1e-5 of the matrix
scale for entries that cancel to near zero."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu import config as jcfg
from reid_tpu.tracking import assignment as ja
from reid_tpu.tracking import costs as jc
from reid_tpu.tracking import kalman as jk
from reid_tpu_torch import config as tcfg
from reid_tpu_torch.tracking import assignment as ta
from reid_tpu_torch.tracking import costs as tc
from reid_tpu_torch.tracking import kalman as tk
from reid_tpu_torch.tracking import methods as tm
from test_torch_train_data import two_torch_threads  # noqa: F401


def T(x):
    return torch.from_numpy(np.asarray(x))


def close(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-5 * max(np.abs(b).max(), 1e-6))


def test_tracker_config_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(
        jcfg.TrackerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(
        tcfg.TrackerConfig)]
    assert jf == tf
    from reid_tpu.tracking.methods import method_config as jmc
    for m in ["strongsort", "deepocsort", "ocsort", "bytetrack", "botsort"]:
        assert dataclasses.asdict(jmc(m)) == dataclasses.asdict(
            tm.method_config(m))


def _states(rng, n):
    xy = rng.uniform(50, 500, (n, 2))
    a = rng.uniform(0.3, 0.6, (n, 1))
    h = rng.uniform(40, 200, (n, 1))
    v = rng.normal(0, 2, (n, 4)) * [1, 1, 0.001, 0.5]
    mean = np.concatenate([xy, a, h, v], 1).astype(np.float32)
    q = rng.normal(0, 1, (n, 8, 8))
    cov = (q @ q.transpose(0, 2, 1) + 8 * np.eye(8)).astype(np.float32)
    return mean, cov


def test_kalman_matches_jax():
    rng = np.random.default_rng(0)
    mean, cov = _states(rng, 24)
    z = (mean[:, :4] + rng.normal(0, 3, (24, 4)) * [1, 1, 0.01, 1]).astype(
        np.float32)
    conf = rng.uniform(0.3, 1.0, 24).astype(np.float32)

    jm, jcov = jk.kalman_predict(jnp.asarray(mean), jnp.asarray(cov))
    tmn, tcov = tk.kalman_predict(T(mean), T(cov))
    close(tmn, jm)
    close(tcov, jcov)

    for c in (None, conf):
        ju = jk.kalman_update(jnp.asarray(mean), jnp.asarray(cov),
                              jnp.asarray(z),
                              None if c is None else jnp.asarray(c))
        tu = tk.kalman_update(T(mean), T(cov), T(z),
                              None if c is None else T(c))
        close(tu[0], ju[0])
        close(tu[1], ju[1])

    ji = jax.vmap(jk.kalman_initiate)(jnp.asarray(z))
    ti = tk.kalman_initiate(T(z))
    close(ti[0], ji[0])
    close(ti[1], ji[1])

    dets = (mean[:10, :4] + rng.normal(0, 10, (10, 4)) * [1, 1, 0.01, 1]
            ).astype(np.float32)
    jg = jax.vmap(jk.kalman_gating_distance, in_axes=(0, 0, None))(
        jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(dets))
    close(tk.kalman_gating_distance(T(mean), T(cov), T(dets)), jg)


def test_costs_match_jax():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(0, 300, (12, 2)),
                        rng.uniform(10, 90, (12, 2))], 1).astype(np.float32)
    b = np.concatenate([a[:5, :2] + rng.normal(0, 5, (5, 2)), a[:5, 2:]], 1)
    b = np.concatenate([b, a[7:10]], 0).astype(np.float32)
    for jf, tf in ((jc.iou_matrix, tc.iou_matrix),
                   (jc.diou_matrix, tc.diou_matrix)):
        np.testing.assert_allclose(tf(T(a), T(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(a),
                                                 jnp.asarray(b))),
                                   rtol=1e-6, atol=1e-6)
    fa = rng.normal(size=(12, 32)).astype(np.float32)
    fb = rng.normal(size=(8, 32)).astype(np.float32)
    fa[3] = 0.0                                  # a zero (unfilled) feature
    np.testing.assert_allclose(
        tc.appearance_cost(T(fa), T(fb)).numpy(),
        np.asarray(jc.appearance_cost(jnp.asarray(fa), jnp.asarray(fb))),
        rtol=1e-5, atol=1e-6)


def _cost(rng, t, d, ties):
    c = rng.uniform(0, 1, (t, d)).astype(np.float32)
    c[rng.random((t, d)) < 0.3] = ja.INF_COST
    if ties:
        # exact ties: repeated values within rows, columns and globally
        c = np.round(c * 4) / 4
        c[c >= 2.5] = ja.INF_COST
    return c


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(16, 8), (8, 8), (6, 10)])
def test_assignment_matches_jax(shape, ties):
    rng = np.random.default_rng(hash((shape, ties)) % 2 ** 32)
    t, d = shape
    for trial in range(4):
        c = _cost(rng, t, d, ties)
        n = min(t, d)
        np.testing.assert_array_equal(
            ta.greedy_assign(T(c), n).numpy(),
            np.asarray(ja.greedy_assign(jnp.asarray(c), n)))
        np.testing.assert_array_equal(
            ta.greedy_assign_rounds(T(c), n).numpy(),
            np.asarray(ja.greedy_assign_rounds(jnp.asarray(c), n)))
        rv = rng.random(t) < 0.8
        cv = rng.random(d) < 0.8
        for method in ("greedy", "greedy_rounds", "auction"):
            got = ta.gated_matches(T(c), T(rv), T(cv), 0.6, method=method)
            want = ja.gated_matches(jnp.asarray(c), jnp.asarray(rv),
                                    jnp.asarray(cv), 0.6, method=method)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_auction_matches_jax():
    rng = np.random.default_rng(5)
    for n in (4, 9):
        c = rng.uniform(0, 2, (n, n)).astype(np.float32)
        np.testing.assert_array_equal(
            ta.auction_assign(T(c)).numpy(),
            np.asarray(ja.auction_assign(jnp.asarray(c))))
