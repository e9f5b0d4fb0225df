"""The tracking chunk as a deployment artifact: the port's chunk exported
with `torch.export` (`pipeline.chunk_serving_fn`, a `.pt2` of static
shapes) and reloaded, against its own eager chunk and the JAX package's
jitted chunk program, on tests/test_utils.py's export configuration
(TrackerConfig(max_tracks=8, max_dets=4, n_init=1, crop_hw=(16, 8)),
chunk 4, its toy embed, inputs from `np.random.default_rng(0)`) over two
chunks, the state carried between them.

Per configuration (strongsort with each assignment, ocsort with ORU and
OCR, botsort with the chunk's affines estimated in the graph): the
artifact equals the eager chunk bit for bit, outputs and state; against
JAX, ids, valid and the integer state leaves are equal, out tlwh within
1e-5 (JAX's own limit for its artifact) and the float state leaves within
1e-4 of their scale. The exported graph reads nothing on the host (no
`aten._local_scalar_dense`) and holds the loops as `while_loop` nodes;
the eager chunk never reaches one. And the layers that set cuDNN's TF32
flag around a convolution export it as a `conv2d_tf32` node, bit-equal to
eager."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.config import TrackerConfig as JConfig
from reid_tpu.tracking.methods import method_config as jmc
from reid_tpu.tracking.pipeline import make_chunked_tracker as jmake
from reid_tpu.tracking.tracker import init_tracker_state as jinit
from reid_tpu_torch.config import TrackerConfig as TConfig
from reid_tpu_torch.tracking import assignment, tracker
from reid_tpu_torch.tracking.methods import method_config as tmc
from reid_tpu_torch.tracking.pipeline import (chunk_serving_fn,
                                              make_chunked_tracker)
from reid_tpu_torch.tracking.tracker import TrackerState, init_tracker_state
from reid_tpu_torch.utils.export import export_serving_fn, load_serving_fn
from test_torch_train_data import two_torch_threads  # noqa: F401

KW = dict(max_tracks=8, max_dets=4, n_init=1, crop_hw=(16, 8))
CHUNK, FEAT = 4, 6
N = len(TrackerState._fields)
INT_LEAVES = {"status", "hits", "time_since_update", "track_id", "next_id",
              "gallery_count"}
CONFIGS = {
    "strongsort greedy_rounds": (None, {}),
    "strongsort greedy": (None, {"assignment": "greedy"}),
    "strongsort auction": (None, {"assignment": "auction"}),
    "ocsort": ("ocsort", {}),
    "botsort gmc": ("botsort", {}),
}


def jax_embed(params, batch_stats, crops):
    m = jnp.mean(crops, axis=(1, 2))
    return jnp.concatenate([m, m * 2.0], axis=1)


def torch_embed(crops):
    m = crops.to(torch.float32).mean(dim=(1, 2))
    return torch.cat([m, m * 2.0], dim=1)


def chunks():
    """Two chunks of tests/test_utils.py's draws: frames (4, 32, 48, 3),
    tlwh (4, 4, 4) in [0, 20), conf 0.9; every box valid in the first, a
    drawn quarter missing in the second, so tracks go unmatched and are
    reacquired."""
    rng = np.random.default_rng(0)
    out = []
    for c in range(2):
        frames = rng.integers(0, 255, (CHUNK, 32, 48, 3)).astype(np.uint8)
        tlwh = rng.uniform(0, 20, (CHUNK, 4, 4)).astype(np.float32)
        conf = np.full((CHUNK, 4), 0.9, np.float32)
        valid = np.ones((CHUNK, 4), bool) if c == 0 else \
            rng.random((CHUNK, 4)) > 0.25
        out.append((frames, tlwh, conf, valid))
    return out


def configs(name):
    method, over = CONFIGS[name]
    if method is None:
        return JConfig(**KW, **over), TConfig(**KW, **over)
    return jmc(method, **KW, **over), tmc(method, **KW, **over)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's jitted chunk program over both chunks, once a configuration:
    (outputs, final state) as numpy."""
    cache = {}

    def run(name):
        if name not in cache:
            cfg = configs(name)[0]
            run_chunk = jax.jit(jmake(cfg, jax_embed, cfg.crop_hw,
                                      chunk=CHUNK))
            state, outs, prev = jinit(8, FEAT), [], None
            for frames, tlwh, conf, valid in chunks():
                anchor = frames[0] if prev is None else prev
                kw = {"prev_frame": jnp.asarray(anchor)} \
                    if cfg.method == "botsort" else {}
                state, out = run_chunk({}, {}, state, jnp.asarray(frames),
                                       jnp.asarray(tlwh), jnp.asarray(conf),
                                       jnp.asarray(valid), **kw)
                outs.append({k: np.asarray(v) for k, v in out.items()})
                prev = frames[-1]
            cache[name] = (outs, [np.asarray(x) for x in state])
        return cache[name]
    return run


def flat_inputs(state, frames, tlwh, conf, valid, prev, gmc):
    args = tuple(state) + tuple(torch.from_numpy(x)
                                for x in (frames, tlwh, conf, valid))
    return args + ((torch.from_numpy(prev),) if gmc else ())


def run_port(fn, gmc):
    """`fn` (the flat chunk function or its artifact) over both chunks:
    the outputs (tlwh, ids, valid) of each, and the final state."""
    state = tuple(init_tracker_state(8, FEAT, device="cpu"))
    outs, prev = [], None
    for frames, tlwh, conf, valid in chunks():
        anchor = frames[0] if prev is None else prev
        res = fn(*flat_inputs(state, frames, tlwh, conf, valid, anchor,
                              gmc))
        state, outs = res[:N], outs + [res[N:]]
        prev = frames[-1]
    return outs, state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunk_artifact_matches_eager_and_jax(name, jax_runs, tmp_path,
                                              monkeypatch):
    cfg = configs(name)[1]
    chunked = make_chunked_tracker(cfg, torch_embed, cfg.crop_hw,
                                   chunk=CHUNK)
    serving = chunk_serving_fn(chunked)
    # the eager chunk: host reads, no while_loop, and (ocsort) an ORU
    # replay of at least one round
    replay_rounds = []
    eager_loop = tracker.device_loop

    def spy(cond, body, carry, max_iters):
        replay_rounds.append(float(max_iters))
        return eager_loop(cond, body, carry, max_iters)

    def refuse(*args, **kwargs):
        raise AssertionError("the eager chunk reached a while_loop")

    monkeypatch.setattr(tracker, "device_loop", spy)
    monkeypatch.setattr(torch._higher_order_ops, "while_loop", refuse)
    assignment.reset_host_reads()
    eager_outs, eager_state = run_port(serving, chunked.use_gmc)
    assert assignment.host_reads() > 0
    assert (max(replay_rounds, default=0) >= 1) == cfg.oru
    monkeypatch.undo()

    path = str(tmp_path / "chunk.pt2")
    state0 = tuple(init_tracker_state(8, FEAT, device="cpu"))
    frames, tlwh, conf, valid = chunks()[0]
    ep = export_serving_fn(serving, flat_inputs(
        state0, frames, tlwh, conf, valid, frames[0], chunked.use_gmc),
        path, dynamic_batch=False)
    targets = [str(n.target) for _, m in ep.graph_module.named_modules()
               for n in m.graph.nodes if n.op == "call_function"]
    assert not any("_local_scalar_dense" in t for t in targets)
    assert sum("while_loop" in t for t in targets) >= 2  # frames, matching
    loaded = load_serving_fn(path)
    outs, state = run_port(loaded, chunked.use_gmc)

    for got, want in zip(outs, eager_outs):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for field, g, w in zip(TrackerState._fields, state, eager_state):
        assert torch.equal(g, w), field

    jouts, jstate = jax_runs(name)
    for (tl, ids, vd), jo in zip(outs, jouts):
        np.testing.assert_array_equal(vd.numpy(), jo["valid"])
        np.testing.assert_array_equal(ids.numpy(), jo["ids"])
        v = jo["valid"]
        np.testing.assert_allclose(tl.numpy()[v], jo["tlwh"][v], rtol=0,
                                   atol=1e-5)
    assert sum(int(jo["valid"].sum()) for jo in jouts) > 0
    for field, g, w in zip(TrackerState._fields, state, jstate):
        if field in INT_LEAVES:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1.0),
                err_msg=field)


def test_layer_tf32_setting_is_a_node_of_the_graph(tmp_path):
    """The convolutions that set cuDNN's TF32 flag themselves (a bf16
    `Conv2d(keep_f32=True)` and the int8 grouped route `grouped_acc`)
    export as `reid_tpu_torch::conv2d_tf32` nodes, which carry the flag
    into the artifact, and the loaded artifact equals eager bit for
    bit."""
    from reid_tpu_torch.models.layers import Conv2d
    from reid_tpu_torch.utils.quantize import grouped_acc

    conv = Conv2d(8, 16, 3, padding=1, dtype=torch.bfloat16, keep_f32=True)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 6, 5, 8)).astype(np.float32))
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 6, 5, 8)).astype(
        np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (8, 1, 3, 3)).astype(
        np.int8))

    def fn(x, xq):
        return conv(x), grouped_acc(xq, wq, 1, 1, 8)

    path = str(tmp_path / "convs.pt2")
    with torch.no_grad():
        ep = export_serving_fn(fn, (x, xq), path)
        assert str(ep.graph).count("reid_tpu_torch.conv2d_tf32") == 2
        got, want = load_serving_fn(path)(x, xq), fn(x, xq)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
