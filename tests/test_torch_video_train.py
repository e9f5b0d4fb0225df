"""Video ReID training in the port (`train/video_train.py`, the staircase
schedule, MADGRAD without a clip, `cli.video_main`) against the JAX
package's, on MOT16-shaped JPEG trees written from a seed.

  * `VideoTrackletDataset` on a two-sequence tree (relabelling across
    sequences, a distractor class, boxes of w or h <= 10 dropped, the
    lamda dilation, tracklets shorter and longer than seq_len): the
    labels and tracklets equal JAX's, and with one seed `load_sequence`
    and `batches` give arrays equal to JAX's (the same PIL decode and
    resize, the same `numpy.random.Generator` draws).
  * The staircase exponential decay equals the jitted
    `optax.exponential_decay(1e-4, 300, 0.5, staircase=True)` at steps 0,
    299, 300, 301, 600 and 10,000.
  * `Madgrad(grad_clip=None)` against bare `reid_tpu.train.optim.madgrad`
    (momentum 0, weight decay 5e-4) under that schedule, 4 steps of
    random gradients: parameters and moment sums within 1e-5 of each
    tensor's largest magnitude (the cube root's ulps, see
    tests/test_torch_plr_train.py), and the caller's gradients left as
    they were.
  * One JAX run of `train_video` on tests/test_video_train.py's tree (2
    identities, bs 2, seq_len 2, 32x16, f32, two epochs of one step),
    its `build_model` handed `VideoResNet(blocks=(1, 1, 1, 1))` (the
    model's widths, one block a stage, so that XLA compiles in seconds)
    and its step wrapped to record each step's carry and batch. From its
    first carry the port's `make_video_train_step` on the same batch:
    the loss equal to 1e-5 relative (read: equal); the gradient
    (MADGRAD's first moment sum, lr g) within 1e-3 of its norm (read
    1.4e-4); the centers' step, -0.5 gc / lamda, within 1e-3 of its norm
    (read 9.8e-6); the parameter update at a cosine of at least 0.999
    and within 2% of its norm (read 1 - 1.4e-7 and 0.05%; MADGRAD's
    first step moves each element by about lr^(2/3) |g|^(1/3) sign(g), so
    elements whose gradient is rounding noise step either way); the
    batch statistics within 1e-4 of their largest magnitude.
  * The port's `train_video` from the same init and centers (its
    `build_model` and `init_hybrid_state` handed JAX's): the loss of
    each step within 1e-4 relative of JAX's (read: equal, then 4.9e-6).
  * `video_main`: the same flags and defaults as JAX's (both runs'
    `train_video` arguments recorded), and a run of the port's on the
    CPU, one epoch in bf16, whose final loss is printed and whose
    variables are the model's flax tree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import reid_tpu.config as jcfg
import reid_tpu.train.video_train as jvt
from reid_tpu.models import video3d as jv
from reid_tpu.train.optim import madgrad as jmadgrad
from reid_tpu_torch import cli
from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
from reid_tpu_torch.models import video3d as tv
from reid_tpu_torch.train import video_train as tvt
from reid_tpu_torch.train.optim import Madgrad
from reid_tpu_torch.train.schedules import staircase_exponential_schedule
from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                              torch_state_dict)
from test_torch_attention import close, tree
from test_torch_plr_train import random_tree, tensors
from test_torch_train_data import two_torch_threads  # noqa: F401


def write_sequence(root, name, tracks, n_frames, rng, hw=(120, 160)):
    """MOT16 sequence `name` under `root`: JPEG frames and a gt.txt with
    the rows of `tracks` in order, each (track id, x, y, w, h, class,
    frames or None for all); a track's rows must come together."""
    seq = os.path.join(root, name)
    os.makedirs(os.path.join(seq, "gt"), exist_ok=True)
    os.makedirs(os.path.join(seq, "img1"), exist_ok=True)
    for frame in range(1, n_frames + 1):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8)).save(
            os.path.join(seq, "img1", f"{frame:06d}.jpg"))
    rows = []
    for tid, x, y, w, h, cls, frames in tracks:
        for frame in frames or range(1, n_frames + 1):
            rows.append(f"{frame},{tid},{x},{y},{w},{h},1,{cls},1")
    path = os.path.join(seq, "gt", "gt.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


@pytest.fixture(scope="module")
def jax_test_tree(tmp_path_factory):
    """tests/test_video_train.py's tree: two pedestrians and a
    distractor over 6 frames of 120x160."""
    root = str(tmp_path_factory.mktemp("mot"))
    gt = write_sequence(root, "MOT16-02", [(1, 10, 10, 30, 60, 1, None),
                                           (2, 80, 20, 30, 60, 1, None),
                                           (3, 5, 5, 30, 60, 7, None)],
                        6, np.random.default_rng(0))
    return root, gt


@pytest.fixture(scope="module")
def two_sequences(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mot2"))
    rng = np.random.default_rng(3)
    # track 2's rows are 8 wide in frames 1-4 (dropped) and 30 wide
    # after; track 3 is a distractor; seq 2's track 2 sits in the corner
    gt1 = write_sequence(root, "MOT16-02", [
        (1, 10, 10, 30, 60, 1, None), (2, 80, 20, 8, 60, 1, range(1, 5)),
        (2, 80, 20, 30, 60, 1, range(5, 13)), (3, 5, 5, 30, 60, 7, None),
        (4, 60, 40, 40, 50, 1, range(2, 5)),
        (5, 100, 30, 24, 70, 1, None)], 12, rng)
    gt2 = write_sequence(root, "MOT16-04", [
        (1, 20, 15, 35, 70, 1, None), (2, 3, 2, 12, 12, 1, None),
        (3, 90, 50, 30, 40, 1, range(3, 9))], 8, rng)
    return root, [gt1, gt2]


@pytest.mark.parametrize("seq_len,lamda", [(4, 1.0), (8, 1.5)])
def test_dataset_matches_jax(two_sequences, seq_len, lamda):
    root, gts = two_sequences
    kw = dict(seq_len=seq_len, lamda=lamda, prefix_image_path=root,
              height=32, width=16)
    want = jvt.VideoTrackletDataset(gts, **kw)
    got = tvt.VideoTrackletDataset(gts, **kw)
    # the distractor takes no label; labels run on across sequences
    assert got.labels == want.labels == list(range(7))
    assert dict(got.gt_info) == dict(want.gt_info)
    # track 2's 8-wide rows dropped, kept once dilated to 12
    assert len(got.gt_info[1]) == (8 if lamda == 1.0 else 12)
    assert [f for _, f, _ in got.gt_info[4]] == list(range(1, 9))
    assert got.gt_info[4][0][2] == "MOT16-04"
    for item in range(len(got)):
        a = got.load_sequence(item, np.random.default_rng(item))
        b = want.load_sequence(item, np.random.default_rng(item))
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].shape == (seq_len, 32, 16, 3) and a[0].dtype == np.uint8
    gb = list(got.batches(4, np.random.default_rng(7)))
    wb = list(want.batches(4, np.random.default_rng(7)))
    assert len(gb) == len(wb) == 2 and len(gb[1]["labels"]) == 4
    for g, w in zip(gb, wb):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert gb[0]["images"].shape == (4, seq_len, 32, 16, 3)


def test_staircase_schedule_matches_optax():
    want = jax.jit(optax.exponential_decay(1e-4, 300, 0.5, staircase=True))
    got = staircase_exponential_schedule(1e-4, 300, 0.5)
    for step in (0, 299, 300, 301, 600, 10_000):
        assert np.float32(got(step)) == np.float32(want(jnp.int32(step))), \
            step
    assert got(300) == got(599) == float(np.float32(5e-5))


def test_madgrad_without_clip_matches_jax():
    rng = np.random.default_rng(4)
    params = random_tree(rng)
    grads = [random_tree(rng, scale=s) for s in (0.5, 30.0, 0.01, 2.0)]
    tx = jmadgrad(optax.exponential_decay(1e-4, 2, 0.5, staircase=True),
                  momentum=0.0, weight_decay=5e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = Madgrad(staircase_exponential_schedule(1e-4, 2, 0.5), 5e-4, None,
                  momentum=0.0)
    assert opt.grad_clip is None
    tp = tensors(params)
    ts = opt.init(tp)
    step = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for g in grads:
        upd, js = step(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = tensors(g)
        kept = [t.clone() for t in tg]
        opt.apply(tp, tg, ts)
        assert all(torch.equal(a, b) for a, b in zip(tg, kept))
    assert ts["count"] == int(js.count) == 4
    for got, w in zip(tp, tensors(tree(jp))):
        close(got.numpy(), w.numpy(), 1e-5)
    for key in ("grad_sum", "grad_sum_sq"):
        for got, w in zip(ts[key], tensors(tree(getattr(js, key)))):
            close(got.numpy(), w.numpy(), 1e-5)


SMALL = dict(blocks=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def jax_run(jax_test_tree):
    """JAX's `train_video` over two epochs with the small model, each
    step's carry before it, its batch, and the losses."""
    root, gt = jax_test_tree
    record = []
    make = jvt.make_video_train_step

    def recording(cfg, model, tx):
        step = make(cfg, model, tx)

        def run(carry, batch):
            record.append((tree(carry), tree(batch)))
            return step(carry, batch)
        return run
    ds = jvt.VideoTrackletDataset([gt], seq_len=2, prefix_image_path=root,
                                  height=32, width=16)
    cfg = jcfg.Config(model=jcfg.ModelConfig(dtype="float32"),
                      train=jcfg.TrainConfig(seed=0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvt, "make_video_train_step", recording)
        mp.setattr(jvt, "build_model", lambda name, num_classes, **kw:
                   jv.VideoResNet(num_classes=num_classes, **SMALL, **kw))
        variables, losses = jvt.train_video(cfg, ds, epochs=2, batch_size=2,
                                            seq_len=2)
    return record, tree(variables), losses, (root, gt)


def port_state(carry):
    """The port's state (small model, f32, on the CPU) at a JAX carry:
    its parameters, statistics and centers, MADGRAD started from them."""
    params, batch_stats, _, loss_state = carry
    model = tv.VideoResNet(num_classes=2, **SMALL)
    load_flax_variables(model, {"params": params,
                                "batch_stats": batch_stats})
    state = tvt.create_video_train_state(model, 2,
                                         torch.Generator().manual_seed(1))
    state.loss_state = state.loss_state._replace(
        centers=torch.from_numpy(np.array(loss_state.centers)))
    return state


def flat(trees):
    return torch.cat([t.reshape(-1) for t in trees]).double()


def test_step_matches_jax(jax_run):
    record, _, losses, _ = jax_run
    (carry0, batch), (carry1, _) = record[0], record[1]
    state = port_state(carry0)
    params0 = [p.detach().clone() for p in state.params()]
    c0 = state.loss_state.centers.clone()
    cfg = Config(model=ModelConfig(dtype="float32"))
    state, loss = tvt.make_video_train_step(cfg)(
        state, tvt.to_device(batch, "cpu"))
    assert abs(float(loss) - losses[0]) <= 1e-5 * abs(losses[0])
    names = [n for n, _ in state.model.named_parameters()]

    def jax_tensors(t):
        sd = torch_state_dict({"params": t})
        return [sd[n] for n in names]
    want_s = flat(jax_tensors(carry1[2].grad_sum))
    got_s = flat(state.opt_state["grad_sum"])
    assert float((got_s - want_s).norm() / want_s.norm()) <= 1e-3
    want_dc = torch.from_numpy(carry1[3].centers).double() - c0.double()
    got_dc = (state.loss_state.centers - c0).double()
    assert float((got_dc - want_dc).norm() / want_dc.norm()) <= 1e-3
    want_u = flat(jax_tensors(carry1[0])) - flat(params0)
    got_u = flat(state.params()) - flat(params0)
    got_u, want_u = got_u.detach(), want_u.detach()
    cos = float(got_u @ want_u / (got_u.norm() * want_u.norm()))
    assert cos >= 0.999 and float((got_u - want_u).norm()
                                  / want_u.norm()) <= 0.02, cos
    stats = torch_state_dict({"batch_stats": carry1[1]})
    for name, buf in state.model.named_buffers():
        close(buf.numpy(), stats[name].numpy(), 1e-4)


def test_train_video_matches_jax(jax_run, monkeypatch):
    record, variables, losses, (root, gt) = jax_run
    carry0 = record[0][0]

    def build(name, num_classes, dtype, device, generator):
        assert name == "video_resnet50" and dtype == torch.float32
        model = tv.VideoResNet(num_classes=num_classes, **SMALL)
        load_flax_variables(model, {"params": carry0[0],
                                    "batch_stats": carry0[1]})
        return model
    init_state = tvt.init_hybrid_state

    def centers(num_classes, feat_dim, generator, device):
        assert feat_dim == 2048
        st = init_state(num_classes, feat_dim, generator, device)
        return st._replace(centers=torch.from_numpy(carry0[3].centers))
    monkeypatch.setattr(tvt, "build_model", build)
    monkeypatch.setattr(tvt, "init_hybrid_state", centers)
    ds = tvt.VideoTrackletDataset([gt], seq_len=2, prefix_image_path=root,
                                  height=32, width=16)
    cfg = Config(model=ModelConfig(dtype="float32"),
                 train=TrainConfig(seed=0))
    got_v, got = tvt.train_video(cfg, ds, epochs=2, batch_size=2,
                                 seq_len=2, device="cpu")
    assert len(got) == len(losses) == 2 and isinstance(got[0], float)
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    assert jax.tree_util.tree_map(np.shape, got_v) == \
        jax.tree_util.tree_map(np.shape, variables)


def test_video_main_flags_match_jax(jax_test_tree, monkeypatch):
    root, gt = jax_test_tree
    seen = {}

    def recorder(key):
        def train_video(cfg, ds, **kw):
            seen[key] = (cfg.model.dtype, cfg.train.seed, ds.seq_len,
                         ds.lamda, ds.prefix, ds.height, ds.width,
                         ds.labels, {k: v for k, v in kw.items()
                                     if k != "device"})
            return {}, [1.0]
        return train_video
    import reid_tpu.cli as jcli
    monkeypatch.setattr(jvt, "train_video", recorder("jax"))
    monkeypatch.setattr(tvt, "train_video", recorder("torch"))
    for flags in ([], ["--bs", "4", "--epochs", "3", "--seq_len", "5",
                       "--crop_factor", "1.2"]):
        argv = ["--gt_paths", gt, "--prefix", root] + flags
        jcli.video_main(argv)
        cli.video_main(argv, device="cpu")
        assert seen["jax"] == seen["torch"], seen
    assert seen["jax"][-1] == dict(epochs=3, batch_size=4, seq_len=5)
    monkeypatch.chdir(root)
    for main, key in ((jcli.video_main, "jax"),
                      (lambda a: cli.video_main(a, device="cpu"), "torch")):
        main(["--gt_paths", gt])
        assert seen[key][4] == "datasets/MOT16/train/"
        assert seen[key][-1] == dict(epochs=25, batch_size=8, seq_len=10)
        assert seen[key][:2] == ("bfloat16", 0)


def test_video_main_runs(jax_test_tree, monkeypatch, capsys):
    root, gt = jax_test_tree
    monkeypatch.setattr(tvt, "build_model", lambda name, num_classes, **kw:
                        tv.VideoResNet(num_classes=num_classes, **SMALL,
                                       dtype=kw["dtype"]).init_weights(
                                           kw["generator"]))
    with torch.backends.mkldnn.flags(enabled=False):
        variables = cli.video_main(["--gt_paths", gt, "--prefix", root,
                                    "--epochs", "1", "--bs", "2",
                                    "--seq_len", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "video training complete; final loss" in out
    loss = float(out.strip().split()[-1])
    assert np.isfinite(loss)
    assert variables["params"]["classifier"]["kernel"].shape == (2048, 2)
    assert variables["params"]["layer1_0"]["conv2"]["kernel"].shape == \
        (3, 3, 3, 64, 64)
    assert all(np.isfinite(a).all()
               for a in jax.tree_util.tree_leaves(variables))
