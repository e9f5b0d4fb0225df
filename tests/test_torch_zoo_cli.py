"""The backbones beside SERes18 through the port's three CLIs against the
JAX package's, one run each at the cheapest settings that reach the
`--backbone` branch:

  * `track_main --backbone baseline --int8` and `--backbone cares18
    --int8` on test_torch_cli's 16-frame scene at 64x32 crops (--chunk
    8), both sides from one flax init and one QuantState (JAX's, handed
    to the port), the JAX kernel routes forced on through their
    references: the same (frame, id) rows with boxes within 0.02 px; the
    int8 conv route taken at each of the backbone's ten K1 sites (per
    call, counted where it is patched) and the fused SE block never, on
    both sides; the tracker's feature width from the probe forward, 512
    + classes.
  * `inference_main --backbone agw` on test_torch_retrieval's Market-style
    tree at 80x40 (f32, re-ranking on; D = 2048 + 6), from one set of
    weights, the port's init with the non-local `w_bn` scales made
    non-zero (the JAX run's checkpoint restore hands it them, and its
    `init` returns them, so that XLA compiles no init; the port reads
    them from its `.npz`): CMC identical at every rank, mAP within 1e-6.
  * The port's `train_main --backbone emares18` and `train_main --renorm`
    (SERes18 with BatchRenorm), two epochs of one step (--bs 8
    --instance 2) at 64x32 on that tree: finite losses and parameters, a
    checkpoint whose tree is the port's model's (which
    test_torch_cares.py holds to the flax init's), with `--renorm` its
    int32 `steps` counters at 2. The renorm checkpoint serves through
    `inference_main` and `track_main`, which read it into plain
    BatchNorm (the counters dropped, as the JAX package's restore drops
    what its model lacks); the served model's eval outputs equal the
    renorm model's in f32 within 1e-5 of their largest magnitude (the
    same function, rounded in another order; read: 1.2e-6 on the logits,
    whose random-init classifier sums to values near 0). `--renorm` with
    a ResNet backbone stops at the parser.

  * `track_main --backbone osnet_x0_25` and `--backbone plr_osnet`, each
    in bf16 and with `--int8`, on the same scene with deepocsort, both
    sides from one set of weights (the port's init, PAM's `gamma` at 0.5
    so that the attention shows; the JAX run's checkpoint restore hands
    it them) and, under `--int8`, one QuantState (JAX's): the same (frame,
    id) rows with boxes within 0.02 px; the tracker's width from the
    probe forward,
    512 + classes for OSNet and PLR-OSNet's 2,560-wide feature alone;
    neither K1 nor the fused SE block is ever taken (OSNet's 3x3 convs
    are depthwise). Why deepocsort: a random-init OSNet embeds every crop
    of the scene within a cosine distance of a few 1e-3 of every other
    (SERes18: 2-3e-2), so strongsort's cost, 0.995 of it appearance,
    separates two candidates by less than the two packages' bf16 embeds
    differ (up to 1.6e-5 a row, tests/test_torch_osnet.py), and two tracks
    now and then take each other's detection (read: 16-34% of boxes moved,
    the (frame, id) rows identical); deepocsort weighs the appearance by
    how well it tells the candidates apart.
  * `inference_main --backbone plr_osnet` on the Market-style tree at
    80x40 (f32, re-ranking on; D = 2,560), PAM's `gamma` non-zero: CMC
    identical at every rank, mAP within 1e-6.

The `train_main --backbone resnet50` run is in
tests/test_torch_baseline_train.py; the train steps of cares18, emares18
and a renorm SERes18 against JAX's are in
tests/test_torch_cares_train.py; OSNet's and PLR-OSNet's training in
tests/test_torch_plr_train.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_baseline import BASELINE_K1
from test_torch_cares import K1_SITES as CARES_K1
from test_torch_cli import read_mot, write_scene
from test_torch_quantize import force_jax_routes
from test_torch_retrieval import write_market_tree
from test_torch_train_data import two_torch_threads  # noqa: F401


def test_track_main_baseline_int8_matches_jax(tmp_path, monkeypatch):
    track_int8_matches_jax(tmp_path, monkeypatch, "baseline", BASELINE_K1)


def test_track_main_cares18_int8_matches_jax(tmp_path, monkeypatch):
    track_int8_matches_jax(tmp_path, monkeypatch, "cares18", CARES_K1)


def track_int8_matches_jax(tmp_path, monkeypatch, backbone, k1_sites):
    import reid_tpu.utils.quantize as jqz
    import reid_tpu_torch.utils.quantize as tqz
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu.models import build_model as jbuild
    from reid_tpu_torch import cli
    from reid_tpu_torch.utils.flax_bridge import (quant_state_from_flax,
                                                  save_npz)

    model = jbuild(backbone, num_classes=16, dtype=jnp.bfloat16)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3), jnp.bfloat16))
    jit_eager_apply(monkeypatch, backbone)
    ckpt = str(tmp_path / "init.npz")
    save_npz(ckpt, jax.tree_util.tree_map(np.asarray, variables))

    fdir, det = write_scene(tmp_path)
    flags = ["--detections", det, "--frames_dir", fdir, "--chunk", "8",
             "--crop_hw", "64", "32", "--num_classes", "16", "--max_dets",
             "8", "--int8", "--backbone", backbone]
    calls = force_jax_routes(monkeypatch)
    qstates = []
    jquantize = jqz.quantize

    def keep_qstate(*a, **kw):
        qstates.append(jquantize(*a, **kw))
        return qstates[-1]
    monkeypatch.setattr(jqz, "quantize", keep_qstate)
    out_j = str(tmp_path / "jax.txt")
    n_j = jax_track_main(flags + ["--save_txt", out_j])
    assert calls["qconv"] > 0 and calls["qblock"] == 0

    # the port takes JAX's QuantState and counts its int8 routes per call
    monkeypatch.setattr(tqz, "quantize", lambda model, batches, select=None:
                        quant_state_from_flax(qstates[0], "cpu"))
    sites = {}
    k1 = tqz.conv3x3_s8

    def counted(x, wt, scale, out_dtype=torch.bfloat16):
        key = (tuple(x.shape[1:]), wt.shape[0])
        sites[key] = sites.get(key, 0) + 1
        return k1(x, wt, scale, out_dtype)
    monkeypatch.setattr(tqz, "conv3x3_s8", counted)
    monkeypatch.setattr(tqz, "se_basic_block_s8", None)
    widths = []
    from reid_tpu_torch.tracking import pipeline as tpipe
    init = tpipe.TrackingPipeline.__init__

    def spy(self, cfg, embed_fn, feat_dim, *a, **kw):
        widths.append(feat_dim)
        init(self, cfg, embed_fn, feat_dim, *a, **kw)
    monkeypatch.setattr(tpipe.TrackingPipeline, "__init__", spy)
    out_t = str(tmp_path / "torch.txt")
    n_t = cli.track_main(flags + ["--save_txt", out_t, "--ckpt", ckpt],
                         device="cpu")
    assert widths == [512 + 16]
    # the ten K1 sites at 64x32 crops (per image: H, W, Cin; and Cout):
    # three at 8x4 c128, three at 4x2 c256, one 256 -> 512 (baseline's
    # layer4_0.conv1, cares18's block41.conv1) and three at 4x2 c512, each
    # taking every embed call (the probe forward and one call a chunk)
    n = sites[((4, 2, 256), 512)]
    assert n >= 3
    assert sites == {((8, 4, 128), 128): 3 * n, ((4, 2, 256), 256): 3 * n,
                     ((4, 2, 256), 512): n, ((4, 2, 512), 512): 3 * n}
    assert 3 + 3 + 1 + 3 == len(k1_sites)
    assert n_t == n_j > 20
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)


@pytest.fixture(scope="module")
def market_tree(tmp_path_factory):
    return write_market_tree(str(tmp_path_factory.mktemp("m") / "market"))


def test_inference_main_agw_matches_jax(market_tree, tmp_path, monkeypatch):
    import reid_tpu.utils as jutils
    from reid_tpu.cli import inference_main as jax_inference_main
    from reid_tpu_torch.cli import inference
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables, save_npz

    v = flax_variables(build_model("agw", num_classes=6, device="cpu"))
    rng = np.random.default_rng(0)
    for nl in ("nl2", "nl3"):
        scale = v["params"][nl]["w_bn"]["scale"]
        v["params"][nl]["w_bn"]["scale"] = rng.normal(
            0, 0.1, scale.shape).astype(np.float32)
    skip_jax_init(monkeypatch, "agw", v)
    monkeypatch.setattr(jutils, "restore_checkpoint",
                        lambda path, state: state.replace(
                            params=jax.tree_util.tree_map(jnp.asarray,
                                                          v["params"]),
                            batch_stats=jax.tree_util.tree_map(
                                jnp.asarray, v["batch_stats"])))
    npz = str(tmp_path / "agw.npz")
    save_npz(npz, v)
    flags = ["--root", market_tree, "--height", "80", "--width", "40",
             "--bs", "8", "--backbone", "agw", "--ckpt"]
    keep = {}
    cmc_j, map_j = jax_inference_main(flags + ["unused"])
    cmc_t, map_t = inference(flags + [npz], device="cpu", keep=keep)
    assert keep["qf"].shape[1] == 2048 + 6
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6, (map_t, map_j)


def flax_tree(backbone, renorm=False):
    """Shapes and dtypes of the backbone's flax variables (6 classes), as
    the port builds them: its tree is the flax init's
    (test_torch_cares.py)."""
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables
    v = flax_variables(build_model(backbone, num_classes=6, device="cpu",
                                   renorm=renorm))
    return jax.tree_util.tree_map(lambda a: (np.shape(a), a.dtype.name), v)


def train_two_steps(root, ckpt_dir, *flags):
    from reid_tpu_torch.cli import train_main
    with torch.backends.mkldnn.flags(enabled=False):
        state = train_main(["--root", root, "--epochs", "2", "--bs", "8",
                            "--instance", "2", "--height", "64", "--width",
                            "32", *flags], device="cpu", ckpt_dir=ckpt_dir)
    assert state.step == 2
    for p in state.model.parameters():
        assert torch.isfinite(p).all()
    return state


@pytest.fixture(scope="module")
def market64(tmp_path_factory):
    return write_market_tree(str(tmp_path_factory.mktemp("m64") / "m"))


def test_train_main_emares18(market64, tmp_path):
    from reid_tpu_torch.models.ema_attention import EMAttention
    from reid_tpu_torch.utils.flax_bridge import load_npz
    state = train_two_steps(market64, str(tmp_path), "--backbone",
                            "emares18")
    assert sum(isinstance(m, EMAttention) for m in state.model.modules()) \
        == 8
    saved = load_npz(str(tmp_path / "cnn_net_checkpoint_market1501.npz"))
    assert jax.tree_util.tree_map(
        lambda a: (np.shape(a), a.dtype.name), saved) == flax_tree(
            "emares18")


def test_train_main_renorm_serves(market64, tmp_path):
    from reid_tpu_torch.cli import inference, track_main
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.models.layers import BatchNorm, BatchRenorm
    from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                                  load_npz)
    state = train_two_steps(market64, str(tmp_path), "--renorm")
    renorms = [m for m in state.model.modules()
               if isinstance(m, BatchRenorm)]
    assert len(renorms) == 20
    assert all(m.steps.dtype == torch.int32 and int(m.steps) == 2
               for m in renorms)
    npz = str(tmp_path / "cnn_net_checkpoint_market1501.npz")
    saved = load_npz(npz)
    assert jax.tree_util.tree_map(
        lambda a: (np.shape(a), a.dtype.name), saved) == flax_tree(
            "seres18", renorm=True)
    assert int(saved["batch_stats"]["bn0"]["steps"]) == 2

    # serving reads it into plain BatchNorm: the same eval function (held
    # in f32, where a rounding moved by the order stays an f32 ulp)
    served = build_model("seres18", num_classes=6, device="cpu")
    load_flax_variables(served, npz)
    assert not any(isinstance(m, BatchRenorm) for m in served.modules())
    assert isinstance(served.bn0, BatchNorm)
    trained = build_model("seres18", num_classes=6, device="cpu",
                          renorm=True)
    load_flax_variables(trained, npz)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 64, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = trained(x)
        got = served(x)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale
    with pytest.raises(RuntimeError, match="Missing key"):
        bad = {k: v for k, v in saved.items()}
        bad["batch_stats"] = dict(saved["batch_stats"])
        del bad["batch_stats"]["bn0"]
        load_flax_variables(build_model("seres18", num_classes=6,
                                        device="cpu"), bad)

    keep = {}
    cmc, mean_ap = inference(["--root", market64, "--ckpt", npz, "--height",
                              "64", "--width", "32", "--bs", "8"],
                             device="cpu", keep=keep)
    assert cmc.shape == (50,) and 0.0 < mean_ap <= 1.0
    assert keep["qf"].shape[1] == 512 + 6
    fdir, det = write_scene(tmp_path)
    out = str(tmp_path / "renorm.txt")
    n = track_main(["--detections", det, "--frames_dir", fdir, "--chunk",
                    "8", "--crop_hw", "64", "32", "--num_classes", "6",
                    "--max_dets", "8", "--ckpt", npz, "--save_txt", out],
                   device="cpu")
    assert n > 20 and read_mot(out).shape[0] == n


def test_train_main_renorm_refuses_resnets(tmp_path):
    from reid_tpu_torch.cli import train_main
    for backbone in ("baseline", "resnet50", "agw", "osnet"):
        with pytest.raises(SystemExit):
            train_main(["--root", str(tmp_path), "--renorm", "--backbone",
                        backbone], device="cpu")
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.models.factory import MODELS, supports_renorm
    with pytest.raises(ValueError, match="renorm"):
        build_model("resnet50", num_classes=4, device="cpu", renorm=True)
    assert {n for n in MODELS if supports_renorm(n)} == {
        "seres18", "cares18", "emares18"}
    assert not supports_renorm("osnet")


def jit_eager_apply(monkeypatch, backbone):
    """JAX's `track_main` runs its width probe (one crop through the
    embed, `reid_tpu/cli.py:556`) outside any jit, op by op: an XLA
    compile an op, about 33 s of the Swin and int8 CARes18 runs. Here
    each call of the backbone's `apply` made outside a trace runs under
    a fresh `jax.jit`, traced under the flax interceptors active at that
    call (the int8 route's is pure and traceable: the CLI's jitted chunk
    program traces it too); inside a trace, and under
    `jax.disable_jit`, `apply` runs as it is. The probe's width is the
    one value that an eager call returns: the chunked path and the
    per-frame path (`make_crop_embed`) run the embed jitted."""
    from reid_tpu.models import build_model as jbuild

    cls = type(jbuild(backbone, num_classes=1))
    apply = cls.apply

    def eager_apply(self, variables, *args, **kwargs):
        leaves = jax.tree_util.tree_leaves((variables, args))
        if any(isinstance(x, jax.core.Tracer) for x in leaves):
            return apply(self, variables, *args, **kwargs)
        return jax.jit(lambda v, *a: apply(self, v, *a, **kwargs))(
            variables, *args)
    monkeypatch.setattr(cls, "apply", eager_apply)


def skip_jax_init(monkeypatch, backbone, v):
    """The JAX CLI's `init` of `backbone` returns `v`, which its
    checkpoint restore (patched by the caller) hands it anyway: XLA then
    compiles no init program."""
    from reid_tpu.models import build_model as jbuild
    monkeypatch.setattr(type(jbuild(backbone, num_classes=1)), "init",
                        lambda self, *a, **k: v)


def osnet_variables(backbone, num_classes, gamma=0.5):
    """The port's init of `backbone` as flax variables, every PAM `gamma`
    at `gamma`."""
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables
    v = flax_variables(build_model(backbone, num_classes=num_classes,
                                   device="cpu"))
    for att in ("att1", "att2"):
        if att in v["params"]:
            v["params"][att]["pam"]["gamma"] = np.asarray([gamma],
                                                          np.float32)
    return v


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("backbone", ["osnet_x0_25", "plr_osnet"])
def test_track_main_osnet_matches_jax(tmp_path, monkeypatch, backbone,
                                      int8):
    import reid_tpu.utils as jutils
    import reid_tpu.utils.quantize as jqz
    import reid_tpu_torch.utils.quantize as tqz
    from reid_tpu.cli import track_main as jax_track_main
    from reid_tpu_torch import cli
    from reid_tpu_torch.tracking import pipeline as tpipe
    from reid_tpu_torch.utils.flax_bridge import (quant_state_from_flax,
                                                  save_npz)

    v = osnet_variables(backbone, 16)
    ckpt = str(tmp_path / "w.npz")
    save_npz(ckpt, v)
    monkeypatch.setattr(jutils, "restore_checkpoint",
                        lambda path, tpl: jax.tree_util.tree_map(
                            jnp.asarray, v))
    skip_jax_init(monkeypatch, backbone, v)
    jit_eager_apply(monkeypatch, backbone)
    fdir, det = write_scene(tmp_path)
    flags = ["--detections", det, "--frames_dir", fdir, "--chunk", "8",
             "--crop_hw", "64", "32", "--num_classes", "16", "--max_dets",
             "8", "--backbone", backbone, "--ckpt", ckpt] + (
                 ["--int8"] if int8 else []) + [
                     "--tracking_method", "deepocsort"]
    calls = force_jax_routes(monkeypatch)
    qstates = []
    jquantize = jqz.quantize

    def keep_qstate(*a, **kw):
        qstates.append(jquantize(*a, **kw))
        return qstates[-1]
    monkeypatch.setattr(jqz, "quantize", keep_qstate)
    out_j = str(tmp_path / "jax.txt")
    n_j = jax_track_main(flags + ["--save_txt", out_j])
    assert calls == {"qconv": 0, "qblock": 0}
    assert len(qstates) == int(int8)

    if int8:
        monkeypatch.setattr(tqz, "quantize",
                            lambda model, batches, select=None:
                            quant_state_from_flax(qstates[0], "cpu"))
    monkeypatch.setattr(tqz, "conv3x3_s8", None)
    monkeypatch.setattr(tqz, "se_basic_block_s8", None)
    widths = []
    init = tpipe.TrackingPipeline.__init__

    def spy(self, cfg, embed_fn, feat_dim, *a, **kw):
        widths.append(feat_dim)
        init(self, cfg, embed_fn, feat_dim, *a, **kw)
    monkeypatch.setattr(tpipe.TrackingPipeline, "__init__", spy)
    out_t = str(tmp_path / "torch.txt")
    n_t = cli.track_main(flags + ["--save_txt", out_t], device="cpu")
    assert widths == [2560 if backbone == "plr_osnet" else 512 + 16]
    assert n_t == n_j > 20
    rj, rt = read_mot(out_j), read_mot(out_t)
    np.testing.assert_array_equal(rt[:, :2], rj[:, :2])
    np.testing.assert_allclose(rt[:, 2:6], rj[:, 2:6], atol=0.02)


def test_inference_main_plr_osnet_matches_jax(market_tree, tmp_path,
                                              monkeypatch):
    import reid_tpu.utils as jutils
    from reid_tpu.cli import inference_main as jax_inference_main
    from reid_tpu_torch.cli import inference
    from reid_tpu_torch.utils.flax_bridge import save_npz

    v = osnet_variables("plr_osnet", 6, gamma=0.3)
    skip_jax_init(monkeypatch, "plr_osnet", v)
    monkeypatch.setattr(jutils, "restore_checkpoint",
                        lambda path, state: state.replace(
                            params=jax.tree_util.tree_map(jnp.asarray,
                                                          v["params"]),
                            batch_stats=jax.tree_util.tree_map(
                                jnp.asarray, v["batch_stats"])))
    npz = str(tmp_path / "plr.npz")
    save_npz(npz, v)
    flags = ["--root", market_tree, "--height", "80", "--width", "40",
             "--bs", "8", "--backbone", "plr_osnet", "--ckpt"]
    keep = {}
    cmc_j, map_j = jax_inference_main(flags + ["unused"])
    cmc_t, map_t = inference(flags + [npz], device="cpu", keep=keep)
    assert keep["qf"].shape[1] == 2560
    np.testing.assert_array_equal(cmc_t, np.asarray(cmc_j))
    assert abs(map_t - map_j) <= 1e-6, (map_t, map_j)
