"""The port's YOLOv5 (`reid_tpu_torch.models.yolo`) against the JAX
package's at yolov5p, 96x160, with the same flax variables (bridged), the
batch statistics moved off their init so that activations keep their
scale through the 24 layers.

Tolerances:
  * the forward in f32: rtol = atol = 1e-4 (the convolutions sum in
    another order);
  * in bf16: every element within 2^-6 of the largest, cosine >= 0.9999
    (the standard of test_seres18_matches_flax[bfloat16]);
  * `decode_yolo`: boxes and scores rtol 1e-6 (the sigmoids are computed
    by two libraries), the order and classes exactly;
  * `nms_fixed`: exactly the serial oracle's survivors, and JAX's output;
  * the detector function in f32: boxes within 1e-3 px, conf within 1e-5,
    the same valid slots;
  * int8: the weight scales and kernels exactly, the activation scales
    of >= 90% of the layers exactly and all within 2^-5 relative (each
    side calibrates on its own bf16 forward, and a rounding flip upstream
    moves an absmax by a few bf16 ulps); with
    JAX's QuantState bridged, the head maps to the bf16 standard and the
    detector's boxes within 0.02 px.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reid_tpu.models import yolo as jy
from reid_tpu.utils.torch_convert import convert_yolov5
from reid_tpu_torch.models import yolo as ty
from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                              quant_state_from_flax)

from test_yolo import TorchYOLOv5, _randomize_torch  # noqa: E402

HW = (96, 160)


def perturb_stats(variables, seed=0):
    """Batch statistics off their init (mean 0, var 1), in place."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                tree[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.2, 1.0, v.shape).astype(np.float32)
    walk(variables["batch_stats"])
    return variables


def flax_yolo(dtype, variant="yolov5p", hw=HW):
    model = jy.build_yolo(variant, num_classes=1, dtype=dtype)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, *hw, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return model, perturb_stats(variables)


def port_yolo(variables, dtype, variant="yolov5p"):
    model = ty.build_yolo(variant, num_classes=1, dtype=dtype, device="cpu")
    load_flax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def bf16_pair():
    fm, v = flax_yolo(jnp.bfloat16)
    return fm, v, port_yolo(v, torch.bfloat16)


@pytest.fixture(scope="module")
def f32_pair():
    fm, v = flax_yolo(jnp.float32)
    return fm, v, port_yolo(v, torch.float32)


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    big = np.abs(want).max()
    assert np.abs(got - want).max() <= big * 2.0 ** -6, (
        np.abs(got - want).max(), big)
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.9999, cos


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_yolov5_forward_matches_flax(dt, f32_pair, bf16_pair):
    fm, v, tm = f32_pair if dt == "float32" else bf16_pair
    x = np.random.default_rng(2).random((2, *HW, 3), dtype=np.float32)
    want = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        if dt == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
        else:
            assert_bf16_close(g.numpy(), w)


def test_decode_yolo_matches_jax():
    rng = np.random.default_rng(3)
    preds = [(rng.normal(size=(2, HW[0] // s, HW[1] // s, 18)) * 2.0
              ).astype(np.float32) for s in ty.YOLO_STRIDES]
    # ties across levels: the same logits in the first cell of each level
    for p in preds:
        p[:, 0, 0, :] = preds[0][:, 0, 0, :]
    xj, sj, cj = jy.decode_yolo([jnp.asarray(p) for p in preds],
                                num_classes=1, max_candidates=128)
    xt, st, ct = ty.decode_yolo([torch.from_numpy(p) for p in preds],
                                num_classes=1, max_candidates=128)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def ladder(rng, n_chain, extra):
    """A suppression ladder (each box overlaps only its neighbours, IoU
    0.54) whose scores fall along the chain, so survival alternates down
    a chain of depth n_chain, and `extra` scattered boxes."""
    xy = np.stack([np.arange(n_chain) * 6.0, np.zeros(n_chain)], 1)
    wh = np.full((n_chain, 2), 20.0)
    xy2 = rng.uniform(0, 300, (extra, 2)) + [0.0, 60.0]
    wh2 = rng.uniform(8, 40, (extra, 2))
    xywh = np.concatenate([np.concatenate([xy, wh], 1),
                           np.concatenate([xy2, wh2], 1)]).astype(np.float32)
    scores = np.concatenate([np.linspace(1.0, 0.4, n_chain),
                             rng.uniform(0.35, 1.0, extra)]).astype(
                                 np.float32)
    return xywh, scores


def crowd(rng, n=300):
    """300 boxes of two classes in a crowd: many overlaps of every depth."""
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    xywh = np.concatenate([xy, wh], 1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return xywh, scores


@pytest.mark.parametrize("case", ["ladder8", "ladder24", "ladder40",
                                  "crowd300"])
def test_nms_fixed_matches_serial_and_jax(case):
    rng = np.random.default_rng(11)
    if case.startswith("ladder"):
        xywh, scores = ladder(rng, int(case[6:]), 10)
        cls = np.zeros(len(xywh), np.float32)
    else:
        xywh, scores = crowd(rng)
        cls = rng.integers(0, 2, len(xywh)).astype(np.float32)
    order = np.argsort(-scores, kind="stable")
    xywh, scores, cls = xywh[order], scores[order], cls[order]
    k = len(xywh)
    stats = {}
    tt, ct, vt = ty.nms_fixed(torch.from_numpy(xywh),
                              torch.from_numpy(scores),
                              torch.from_numpy(cls), iou_thres=0.45,
                              conf_thres=0.3, max_dets=k + 4, stats=stats)
    sup = ty.suppression(torch.from_numpy(xywh), torch.from_numpy(cls),
                         0.45).numpy()
    alive = jy._nms_alive_serial(sup, scores > 0.3)
    assert vt.numpy().sum() == alive.sum()
    np.testing.assert_array_equal(ct.numpy()[vt.numpy()], scores[alive])
    if case == "ladder40":
        assert stats["rounds"] > 20      # a deep chain: many rounds
    tj, cj, vj = jy.nms_fixed(jnp.asarray(xywh), jnp.asarray(scores),
                              jnp.asarray(cls), iou_thres=0.45,
                              conf_thres=0.3, max_dets=k + 4)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


@pytest.mark.parametrize("frame_hw", [(120, 160), (60, 200)],
                         ids=["pad_x", "pad_y"])
def test_yolo_detector_fn_matches_jax(frame_hw, f32_pair):
    fm, v, tm = f32_pair
    frame = np.random.default_rng(4).integers(0, 256, (*frame_hw, 3),
                                              np.uint8)
    # the random init scores every cell near 0.28
    kw = dict(max_dets=32, conf_thres=0.28)
    tj, cj, vj = jy.make_yolo_detector_fn(fm, v, HW, **kw)(frame)
    tt, ct, vt = ty.make_yolo_detector_fn(tm, HW, **kw)(frame)
    assert 0 < vt.sum() < 32
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(ct, cj, atol=1e-5)
    np.testing.assert_allclose(tt[vt], tj[vj], atol=1e-3)


@pytest.fixture(scope="module")
def int8_pair(bf16_pair):
    fm, v, tm = bf16_pair
    frames = np.random.default_rng(5).integers(0, 256, (3, 120, 160, 3),
                                               np.uint8)
    qj = jy.quantize_yolo(fm, v, frames, HW)
    qt = ty.quantize_yolo(tm, frames, HW)
    return fm, v, tm, qj, qt, frames


def test_quantize_yolo_scales_match_jax(int8_pair):
    _, _, _, qj, qt, _ = int8_pair
    assert set(qt.kernels) == set(qj.kernels)
    assert not any(p.startswith("det_m") for p in qt.kernels)
    bridged = quant_state_from_flax(qj, "cpu")
    equal = 0
    for p in qt.kernels:
        assert torch.equal(qt.kernels[p], bridged.kernels[p]), p
        assert torch.equal(qt.w_scales[p], bridged.w_scales[p]), p
        np.testing.assert_allclose(qt.act_scales[p], bridged.act_scales[p],
                                   rtol=2.0 ** -5, err_msg=p)
        equal += qt.act_scales[p] == bridged.act_scales[p]
    assert equal >= 0.9 * len(qt.kernels), (equal, len(qt.kernels))


def test_int8_yolo_matches_jax_quantized_apply(int8_pair):
    from reid_tpu.utils.quantize import quantized_apply
    from reid_tpu_torch.utils.quantize import quantized_model

    fm, v, tm, qj, _, frames = int8_pair
    canvas = ty.letterbox(torch.from_numpy(frames), HW)
    want = jax.jit(lambda vv, xx: quantized_apply(fm, vv, qj, xx,
                                                  train=False))(
        v, jnp.asarray(canvas.numpy()))
    qm = quantized_model(tm, quant_state_from_flax(qj, "cpu"))
    with torch.no_grad():
        got = qm(canvas)
    for g, w in zip(got, want):
        assert_bf16_close(g.numpy(), w)
    # the same detections through both detector functions
    frame = frames[0]
    kw = dict(max_dets=32, conf_thres=0.25)
    tj, cj, vj = jy.make_yolo_detector_fn(fm, v, HW, qstate=qj, **kw)(frame)
    tt, ct, vt = ty.make_yolo_detector_fn(
        tm, HW, qstate=quant_state_from_flax(qj, "cpu"), **kw)(frame)
    assert vt.sum() > 0
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(tt[vt], tj[vj], atol=0.02)


def test_det_torch_state_dict_matches_convert_yolov5(tmp_path):
    """A published-layout state_dict (the ultralytics-named mirror of
    tests/test_yolo.py) loads into the port's YOLOv5 to the same weights
    that `convert_yolov5` gives the flax model; from a `.pt` file too."""
    mirror = TorchYOLOv5("yolov5p", nc=1).eval()
    _randomize_torch(mirror)
    sd = mirror.state_dict()
    fm = jy.build_yolo("yolov5p", num_classes=1)
    init = jax.jit(lambda k, x: fm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    conv = convert_yolov5({"model." + k: t.numpy() for k, t in sd.items()},
                          init)
    want = port_yolo(jax.tree_util.tree_map(np.asarray, conv), torch.float32)
    path = tmp_path / "yolov5p.pt"
    torch.save(sd, path)
    for src in (sd, str(path)):
        got = ty.build_yolo("yolov5p", dtype=torch.float32, device="cpu")
        assert ty.load_yolov5_state_dict(got, src) > 100
        for (n, a), (_, b) in zip(got.state_dict().items(),
                                  want.state_dict().items()):
            assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="no tensor"):
        ty.load_yolov5_state_dict(
            got, {"model.0.conv.weight": torch.zeros(99, 3, 6, 6)})


def test_k1_route_at_qualifying_convs_only():
    """yolov5n: the int8 3x3 stride-1 convs whose Cin and Cout are both
    multiples of 128 (the P5 bottlenecks l8.m0 and l23.m0) take
    `conv3x3_s8`; every other conv takes the im2col route, and the heads
    stay in bf16."""
    from reid_tpu_torch.utils.quantize import QConv2d, quantized_model

    model = ty.build_yolo("yolov5n", dtype=torch.bfloat16, device="cpu")
    frames = np.random.default_rng(6).integers(0, 256, (1, 64, 64, 3),
                                               np.uint8)
    qs = ty.quantize_yolo(model, frames, (64, 64))
    qm = quantized_model(model, qs)
    routed, want = set(), set()
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d) and not name.startswith("det_m"):
            if (m.kernel_size == (3, 3) and m.stride == (1, 1)
                    and m.in_channels % 128 == 0
                    and m.out_channels % 128 == 0):
                want.add(name)
    for name, m in qm.named_modules():
        if isinstance(m, QConv2d) and m.route:
            routed.add(name)
    assert routed == want == {"l8.m0.cv2.conv", "l23.m0.cv2.conv"}
    assert not any(isinstance(getattr(qm, f"det_m{i}"), QConv2d)
                   for i in range(3))
    with torch.no_grad():
        out = qm(ty.letterbox(torch.from_numpy(frames), (64, 64)))
    assert all(torch.isfinite(o).all() for o in out)
