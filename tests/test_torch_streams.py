"""Multi-stream tracking: the port's `make_stream_tracker` against the JAX
package's `make_stream_tracker(mesh=None)` (its streams vmapped on one
device) on S = 3 distinct streams, and each port stream against the port's
own single-stream run of the same frames.

JAX against the port: ids and valid identical, tlwh within 1e-4 (as
tests/test_tracking_chunked.py holds JAX's sharded streams against its
sequential runs). Port streams against port single-stream runs: bit-equal,
since the batched association freezes a finished stream by a mask and the
toy embed works per crop. The int8 case runs a small SERes18 under one
QuantState, the JAX package's carried across (test_torch_quantize.py)."""

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

from reid_tpu.tracking.methods import method_config as jmc  # noqa: E402
from reid_tpu.tracking.streams import (  # noqa: E402
    init_stream_states as jinit, make_stream_tracker as jmake)
from reid_tpu_torch.tracking import assignment as ta  # noqa: E402
from reid_tpu_torch.tracking.methods import method_config as tmc  # noqa
from reid_tpu_torch.tracking.pipeline import make_chunked_tracker  # noqa
from reid_tpu_torch.tracking.streams import (  # noqa: E402
    init_stream_states, make_stream_tracker)
from reid_tpu_torch.tracking.tracker import init_tracker_state  # noqa
from test_torch_gmc import panned_scene  # noqa: E402
from test_torch_train_data import two_torch_threads  # noqa: E402,F401

CROP = (32, 16)
S, T, D, CHUNK = 3, 16, 8, 8


def jax_toy(params, batch_stats, crops):
    """tests/test_tracking_chunked.py's toy embed: mean colour, 9 dims."""
    m = jnp.mean(crops, axis=(1, 2))
    return jnp.concatenate([m, m * 2.0, m * 0.5], axis=1)


def torch_toy(crops):
    m = crops.to(torch.float32).mean(dim=(1, 2))
    return torch.cat([m, m * 2.0, m * 0.5], dim=1)


def streams(method):
    """S distinct scenes, one seed each (a panned one for botsort)."""
    seqs = [panned_scene(t_total=T, max_dets=D, seed=s)
            if method == "botsort" else
            build_mot_scene(t_total=T, n_t=4, max_dets=D, h=120, w=160,
                            seed=s)[:4] for s in range(S)]
    return [np.stack([q[i] for q in seqs]) for i in range(4)]


def run_jax(cfg, embed, data, chunk, feat_dim, budget=None):
    run = jmake(cfg, embed, CROP, chunk=chunk, crop_budget=budget)
    st = jinit(data[0].shape[0], cfg.max_tracks, feat_dim=feat_dim)
    outs = []
    for s in range(0, data[0].shape[1], chunk):
        st, o = run({}, {}, st, *[jnp.asarray(x[:, s:s + chunk])
                                  for x in data])
        outs.append({k: np.asarray(v) for k, v in o.items()})
    return {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}


def run_port(cfg, embed, data, chunk, feat_dim, budget=None):
    run = make_stream_tracker(cfg, embed, CROP, chunk=chunk,
                              crop_budget=budget, device="cpu")
    st = init_stream_states(data[0].shape[0], cfg.max_tracks, feat_dim,
                            device="cpu")
    outs = []
    for s in range(0, data[0].shape[1], chunk):
        st, o = run(st, *[torch.from_numpy(x[:, s:s + chunk]) for x in data])
        outs.append(o)
    return {k: torch.cat([o[k] for o in outs], 1).numpy() for k in outs[0]}


def run_port_single(cfg, embed, data, chunk, feat_dim, budget=None):
    """Each stream alone through the one-stream chunked tracker."""
    run = make_chunked_tracker(cfg, embed, CROP, chunk=chunk,
                               crop_budget=budget)
    per = []
    for si in range(data[0].shape[0]):
        st = init_tracker_state(cfg.max_tracks, feat_dim, device="cpu")
        outs = []
        for s in range(0, data[0].shape[1], chunk):
            st, o = run(st, *[torch.from_numpy(x[si, s:s + chunk])
                              for x in data])
            outs.append(o)
        per.append({k: torch.cat([o[k] for o in outs]).numpy()
                    for k in outs[0]})
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def assert_tracks(got, want, atol):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    v = want["valid"]
    np.testing.assert_allclose(got["tlwh"][v], want["tlwh"][v], atol=atol)


@pytest.mark.parametrize("method,assignment,budget", [
    ("strongsort", "auction", None), ("botsort", "greedy_rounds", 40),
    ("ocsort", "greedy", None)])
def test_streams_match_jax_and_single_stream(method, assignment, budget):
    kw = dict(max_tracks=16, max_dets=D, crop_hw=CROP, assignment=assignment)
    data = streams(method)
    want = run_jax(jmc(method, **kw), jax_toy, data, CHUNK, 9, budget)
    ta.reset_host_reads()
    got = run_port(tmc(method, **kw), torch_toy, data, CHUNK, 9, budget)
    reads = ta.host_reads()
    assert want["valid"].sum() > 3 * 20        # every stream really tracks
    assert_tracks(got, want, 1e-4)
    ta.reset_host_reads()
    single = run_port_single(tmc(method, **kw), torch_toy, data, CHUNK, 9,
                             budget)
    for k in got:                              # bit-equal, stream by stream
        np.testing.assert_array_equal(got[k], single[k], err_msg=k)
    # one host read a round for all streams: fewer than the streams' own
    assert 0 < reads < ta.host_reads()


def test_stream_tracker_checks_its_inputs():
    cfg = tmc("strongsort", max_tracks=8, max_dets=4, crop_hw=CROP)
    with pytest.raises(ValueError, match="mesh="):
        make_stream_tracker(cfg, torch_toy, CROP, device=["cuda:0",
                                                          "cuda:1"])
    run = make_stream_tracker(cfg, torch_toy, CROP, chunk=4, device="cpu")
    st = init_stream_states(2, 8, 9, device="cpu")
    with pytest.raises(ValueError, match="S, T, H, W, 3"):
        run(st, torch.zeros((4, 32, 32, 3), dtype=torch.uint8),
            torch.zeros((4, 4, 4)), torch.zeros((4, 4)),
            torch.zeros((4, 4), dtype=torch.bool))


def test_stream_tracker_and_serving_embed_keep_no_graph():
    """Outside inference mode, with parameters that require grad, neither
    the stream tracker nor the serving embed records an autograd graph."""
    from reid_tpu_torch.eval.serving import make_embed_fn

    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 9)
    seen = []

    def embed(crops):
        f = lin(crops.to(torch.float32).mean(dim=(1, 2)))
        seen.append(f.requires_grad)
        return f

    assert not torch.is_inference_mode_enabled()
    assert torch.is_grad_enabled()
    cfg = tmc("strongsort", max_tracks=8, max_dets=D, crop_hw=CROP)
    data = streams("strongsort")
    run = make_stream_tracker(cfg, embed, CROP, chunk=CHUNK, device="cpu")
    st, out = run(init_stream_states(S, 8, 9, device="cpu"),
                  *[torch.from_numpy(x[:, :CHUNK]) for x in data])
    assert seen == [False]
    assert not any(t.requires_grad for t in st)
    assert not any(t.requires_grad for t in out.values())

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.feat, self.cls = torch.nn.Linear(3, 4), torch.nn.Linear(3, 5)

        def forward(self, x):
            m = x.mean(dim=(1, 2))
            return self.feat(m), self.cls(m)

    emb = make_embed_fn(Net())(torch.full((2, 8, 4, 3), 128.0))
    assert emb.shape == (2, 9) and not emb.requires_grad


def test_int8_seres18_streams_match_jax(monkeypatch):
    """The stream-batched int8 embed (every stream's crops in one SERes18
    call) under the JAX package's QuantState: the same tracks as JAX's
    vmapped streams, and each stream bit-equal to its own run."""
    from reid_tpu.models import build_model as jbuild
    from reid_tpu.utils import quantize as jqz
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils import quantize as tqz
    from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                                  quant_state_from_flax)
    from test_torch_quantize import force_jax_routes

    crop, n_s, t = (64, 32), 2, 4
    model = jbuild("seres18", num_classes=16, dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, *crop, 3), jnp.bfloat16))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    calib = np.random.default_rng(0).normal(size=(8, *crop, 3)).astype(
        np.float32)
    force_jax_routes(monkeypatch)
    qs = jqz.quantize(model, variables, [jnp.asarray(calib)], train=False)

    def jembed(params, batch_stats, crops):
        f, lg = jqz.quantized_apply(model, variables, qs,
                                    crops.astype(jnp.bfloat16), train=False)
        f = jnp.concatenate([f.astype(jnp.float32),
                             lg.astype(jnp.float32)], 1)
        return f / jnp.maximum(jnp.linalg.norm(f, axis=1, keepdims=True),
                               1e-12)

    tm = build_model("seres18", num_classes=16, dtype=torch.bfloat16,
                     device="cpu")
    load_flax_variables(tm, variables)
    qm = tqz.quantized_model(tm, quant_state_from_flax(qs, "cpu"))
    batches = []

    def tembed(crops):
        batches.append(crops.shape[0])
        with torch.no_grad():
            f, lg = qm(crops.to(torch.bfloat16))
        f = torch.cat([f.float(), lg.float()], 1)
        return f / torch.clamp(torch.linalg.norm(f, dim=1, keepdim=True),
                               min=1e-12)

    seqs = [build_mot_scene(t_total=t, n_t=3, max_dets=4, h=120, w=160,
                            seed=10 + s)[:4] for s in range(n_s)]
    data = [np.stack([q[i] for q in seqs]) for i in range(4)]
    kw = dict(max_tracks=8, max_dets=4, crop_hw=crop, n_init=1)
    want = run_jax(jmc("strongsort", **kw), jembed, data, t, 528)
    got = run_port(tmc("strongsort", **kw), tembed, data, t, 528)
    assert batches == [n_s * t * 4]            # one embed call, all streams
    assert want["valid"].sum() > 10
    assert_tracks(got, want, 1e-4)
    single = run_port_single(tmc("strongsort", **kw), tembed, data, t, 528)
    for k in got:
        np.testing.assert_array_equal(got[k], single[k], err_msg=k)
