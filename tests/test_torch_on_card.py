"""The port's CUDA kernels against their plain versions, on a card.

Every test here takes the `cuda` fixture and skips where there is no card.
The file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py

Tolerances:
  * conv3x3_s8: exact. The s32 accumulator is exact on both sides and the
    rescale is one f32 multiply.
  * conv3x3_s8_ncat, _bitshift and _dma: exact against their plain
    versions and against conv3x3_s8, for the same reason; each call one
    launch that allocates no device memory beside its output.
  * se_basic_block_s8: rtol = atol = 1e-4 on >= 99.9% of the elements and
    5e-2 on all, the plain version's tolerance against the JAX reference.
    The plain version sums the per-image means and the SE dot products in
    the kernel's fixed order, so the two agree bit for bit at the shapes
    measured so far; summed in torch's order instead, a mean can differ by
    an ulp and move a requantization tie by one step.
  * the fused block in f32 (the retrieval path's f32 trunk): the same
    limits as in bf16, against the plain version in f32.
  * the int8 embed, card against CPU: cosine >= 0.999 per row.
  * the int8 YOLOv5s detector (random init, seed 1, calibrated on one
    frame), card against CPU with the same weights and QuantState: the
    same number of valid boxes, and each card box within 0.5 px of the
    CPU's box of the same candidate (anchor cell). Output slots are not
    compared: the random init scores every cell within ~1e-4 of 0.25, so
    which candidates NMS keeps can turn on a last-bit difference.
  * sqeuclidean (K6): rtol = atol = 1e-4 against the plain version (norms
    plus a cuBLAS f32 matmul with TF32 off): the kernel sums the dot
    products in another order, about 1e-6 relative apart.
  * l1 (K7): rtol = atol = 1e-5 against the plain version: only the
    summation order differs.
  * smooth_tracklets: a second card run equal to the first bit for bit,
    and atol = 1e-6 against the CPU (the 0/1 matmuls sum in another order).
  * int8 streams (every stream's crops in one embed call, the association
    batched over streams) against each stream's own run on the card: ids
    and valid identical, tlwh within 1e-4; whether every output is
    bit-equal is printed, not held (a batched cuBLAS product may take
    another algorithm than a single one).
  * the int8 serving artifact (torch.export, K1 and K2 as custom ops)
    loaded on the card: K1 and K2 launched (counted) and its output equal
    to the eager int8 embed bit for bit; the int8 tracking chunk as an
    artifact: K1 and K2 launched, ids and valid equal to the eager
    chunk's, tlwh within 1e-4.
  * the train step: two bf16 steps of SERes18 at 256x128 (B = 16, the
    augmentation on the card) give finite losses, parameters and DCC
    tables of unit rows; one f32 step from one state on the card and on
    the CPU (the same augmentation draws, TF32 off) within
    tests/test_torch_train_step.py's limits for a step: loss 1e-4
    relative, statistics, centers and tables 1e-3 of their largest
    magnitude, the parameter update at a cosine >= 0.9995 and within 3%
    of its norm (Adam's steps of elements whose gradient is rounding
    noise); and, after two warm-up steps, a bf16 step under
    torch.cuda's sync debug mode "error": the step reads nothing back
    and copies nothing from the host.
  * OSNet's depthwise int8 conv (the grouped route: an f32 conv with TF32
    off on the card, float64 on the CPU): card and CPU bit-equal, the
    accumulator exact at its extreme (9 x 127^2).
  * PLR-OSNet's train step (MADGRAD without PK sampling, and Adam with
    it), after two warm-up steps, under the sync debug mode "error", with
    finite losses and parameters.
  * ViT and Swin (reduced widths): the bf16 embed, card against CPU,
    cosine >= 0.999 a row; the int8 embed, card against CPU with one
    QuantState, cosine >= 0.999, and neither K1 nor K2 launched (no conv
    of theirs is 3x3 with 128-multiple channels); the transformer train
    step (dropout 0.1, masks drawn on the card; ViT with cams) on both
    optimizer branches after two warm-up steps under the sync debug mode
    "error", and one generator
    seed giving the same step twice.
  * the video step (VideoResNet(blocks=(1, 1, 1, 1)), bf16, 4 clips of 4
    x 64 x 32) after two warm-up steps under the sync debug mode "error",
    finite; its eval forward card against CPU, f32 within rtol = atol =
    1e-4 (TF32 off inside the f32 3-D convs), bf16 at a cosine >= 0.999
    a row.
  * the GAN and detector trainers (reduced widths, f32, TF32 off), one
    step from one state on the card and on the CPU: the DCGAN step with
    G's update, the VAE-GAN step with the Wasserstein gradient penalty
    through the VAE head's BatchNorm, `train_detector` and
    `train_lsro_baseline`, each of one step: losses within 1e-4
    relative; the gradient (Adam's first moment; SGD's update) of the GAN
    steps and LSRO within 1e-3 of its norm (LSRO: or twice the CPU's
    spread between its two convolution algorithms); statistics
    (BatchNorm's, the spectral u and sigma) of the GAN steps and the
    detector within 1e-3 of their largest magnitude; and each GAN step
    and the detector step after two warm-up steps under the sync debug
    mode "error".
  * the distributed layer at world 1 (one card): the row-sharded Jaccard
    without a process group against the dense Jaccard on 512 random
    features (bit-equal, K7 launched once); `train_cnn` on a world-1
    NCCL group against `train_cnn` without one (three f32 steps,
    cuDNN deterministic): losses and weights bit for bit.
  * DeepLabV3 (width 8, head 32) and SegUNet (base 8) in f32, card
    against CPU with TF32 off: logits within 1e-4 of the CPU's largest;
    the composite of `batched_extraction` within 1e-4 of its scale.
"""

import numpy as np
import pytest
import torch

from reid_tpu_torch.ops import distance as tdist
from reid_tpu_torch.ops import launch_counts, reset_launch_counts
from reid_tpu_torch.ops import qblock as tqb
from reid_tpu_torch.ops import qconv as tq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def within(got, want, tight=1e-4, loose=5e-2, share=0.999):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    ok = err <= tight + tight * np.abs(want)
    assert ok.mean() >= share, (ok.mean(), err.max())
    assert np.all(err <= loose + loose * np.abs(want)), err.max()


def conv_inputs(rng, b, h, w, cin, cout, dev):
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (cout, 9 * cin), np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    return x.to(dev), wt.to(dev), scale.to(dev)


def block_params(rng, cin, cout, down, ibn, dev, mip=16):
    """Random folded parameters at the scale of a real block (as the JAX
    package's tests/test_qblock.py makes them)."""
    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, np.int8))

    def f32(n, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))

    half = cout // 2
    zero = torch.zeros(cout - half)
    kw = {}
    if down:
        kw = dict(wd=i8(cout, cin), ad=f32(cout, 0.01, 0.1), cd=f32(cout),
                  inv_sxd=float(np.float32(rng.uniform(5, 20))))
    if ibn:
        kw.update(dq1_vec=f32(cout, 0.001, 0.01),
                  in_scale=torch.cat([f32(half, 0.5, 1.5), zero]),
                  in_bias=torch.cat([f32(half, -0.5, 0.5), zero]),
                  a1=torch.cat([zero, f32(cout - half, 0.1, 1.0)]),
                  c1=torch.cat([zero, f32(cout - half, -0.5, 0.5)]))
    else:
        kw.update(a1=f32(cout, 0.001, 0.01), c1=f32(cout))
    p = tqb.QBlockParams(
        w1=i8(cout, 9 * cin), w2=i8(cout, 9 * cout),
        a2=f32(cout, 0.001, 0.01), c2=f32(cout),
        inv_sx1=float(np.float32(rng.uniform(5, 20))),
        inv_sx2=float(np.float32(rng.uniform(5, 20))),
        wfc1=f32(cout * mip).reshape(cout, mip).to(torch.bfloat16),
        wfc2=f32(mip * cout).reshape(mip, cout).to(torch.bfloat16), **kw)
    return tqb.QBlockParams(*[v.to(dev) if isinstance(v, torch.Tensor)
                              else v for v in p])


@pytest.mark.parametrize("shape", [(4, 32, 16, 128, 128),
                                   (8, 16, 8, 256, 256),
                                   (3, 5, 7, 128, 256),
                                   (2, 9, 11, 64, 128),
                                   (16, 8, 4, 512, 512),
                                   (4, 16, 8, 256, 256),
                                   (2, 6, 10, 64, 256),
                                   (1, 18, 32, 128, 128),
                                   (1, 9, 16, 256, 256),
                                   (1, 24, 40, 128, 128),
                                   (1, 12, 20, 256, 256),
                                   (8, 32, 16, 128, 128),
                                   (8, 16, 8, 512, 512),
                                   (8, 16, 8, 256, 512)])
def test_conv3x3_s8_matches_plain(cuda, shape):
    """Exact in bf16 and f32, one launch each. The shapes cover a tile of
    four whole images (8x4: 32 pixels an image) with Cout split over two
    N tiles of 256, ragged boxes that leave tile rows unused (5x7, 9x11,
    6x10), every tile form (128 x 256 and 256 x 128, K steps of 64 and 128
    channels), one image per tile (16x8), and the YOLOv5s detector's
    call sites, one image a call: at --det_size 288 512 (18x32 with 128
    channels, whose last box holds 2 of its 8 rows; 9x16 with 256, 1 of
    8) and at 384 640 (24x40 and 12x20: box widths of no power of two);
    and the ResNet trunks' sites at 256x128 crops: resnet50's layer2
    (32x16 c128) and layer4 (16x8 c512), and baseline's layer4_0.conv1
    (16x8, 256 -> 512, K1's one call with Cin != Cout on a track path)."""
    args = conv_inputs(np.random.default_rng(1), *shape, cuda)
    for dt in (torch.float32, torch.bfloat16):
        reset_launch_counts()
        got = tq.conv3x3_s8(*args, out_dtype=dt)
        assert launch_counts()[tq.NAME] == 1
        want = tq.conv3x3_s8_plain(*args, out_dtype=dt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_conv3x3_s8_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((1, 4, 4, 96), dtype=torch.int8, device=cuda)
    wt = torch.zeros((128, 9 * 96), dtype=torch.int8, device=cuda)
    s = torch.ones(128, device=cuda)
    with pytest.raises(ValueError):
        tq.conv3x3_s8(x, wt, s)
    with pytest.raises(TypeError):
        tq.conv3x3_s8(x.float(), wt, s)


# each form on (x, K1's packed weight, K3's packed weight, scale, out
# dtype, img_block)
VARIANTS = {
    tq.NCAT: lambda x, wt, wn, s, dt, blk: tq.conv3x3_s8_ncat(
        x, wn, s, blk, dt),
    tq.BITSHIFT: lambda x, wt, wn, s, dt, blk: tq.conv3x3_s8_bitshift(
        x, wt, s, dt),
    tq.DMA: lambda x, wt, wn, s, dt, blk: tq.conv3x3_s8_dma(
        x, wt, s, blk, dt)}
PLAINS = {
    tq.NCAT: lambda x, wt, wn, s, dt, blk: tq.conv3x3_s8_ncat_plain(
        x, wn, s, dt, blk),
    tq.BITSHIFT: lambda x, wt, wn, s, dt, blk: tq.conv3x3_s8_bitshift_plain(
        x, wt, s, dt),
    tq.DMA: lambda x, wt, wn, s, dt, blk: tq.conv3x3_s8_dma_plain(
        x, wt, s, dt, blk)}


# (B, H, W, Cin, Cout), img_block: 9x7 and 8x4 images smaller than a tile
# with a ragged last tile; 32x16 and 20x16, K3's halo bands (H = 20 no
# multiple of a band's 6 rows); Cout = 512, 32 of K3's channel groups;
# Cin = 64, the 64-byte swizzle; and uneven image blocks.
VARIANT_CASES = [((7, 32, 16, 128, 128), 3), ((5, 16, 8, 256, 256), 0),
                 ((3, 5, 7, 128, 256), 2), ((2, 9, 11, 64, 128), 1),
                 ((5, 9, 7, 64, 128), 0), ((3, 8, 4, 128, 256), 0),
                 ((3, 32, 16, 128, 256), 0), ((2, 20, 16, 64, 128), 0),
                 ((2, 16, 8, 128, 512), 0), ((3, 8, 4, 512, 512), 2)]


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("shape,img_block", VARIANT_CASES)
def test_conv3x3_s8_variants_match_plain_and_k1(cuda, name, shape,
                                                img_block):
    """Each of K3-K5 equals its plain version and K1 bit for bit in one
    launch that allocates nothing beside its output."""
    x, wt, scale = conv_inputs(np.random.default_rng(2), *shape, cuda)
    wn = tq.pack_ncat_weight(wt)
    for dt in (torch.float32, torch.bfloat16):
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = VARIANTS[name](x, wt, wn, scale, dt, img_block)
        torch.cuda.synchronize()
        assert launch_counts() == {name: 1}
        # the caching allocator rounds a block up to 512 bytes
        out_bytes = -(-got.numel() * got.element_size() // 512) * 512
        assert torch.cuda.max_memory_allocated() - base == out_bytes
        want = PLAINS[name](x, wt, wn, scale, dt, img_block)
        k1 = tq.conv3x3_s8(x, wt, scale, out_dtype=dt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, k1)


def test_conv3x3_s8_ncat_rejects_a_row_too_wide(cuda):
    """A 64-pixel row leaves no output row in K3's 128-pixel box."""
    x, wt, s = conv_inputs(np.random.default_rng(3), 1, 4, 64, 64, 128, cuda)
    with pytest.raises(ValueError):
        tq.conv3x3_s8_ncat(x, tq.pack_ncat_weight(wt), s)


def test_conv3x3_s8_bitshift_rejects_a_row_too_wide(cuda):
    """A 128-pixel row makes a slab of 258 + 256 rows, more than K4's two
    TMA boxes of 256 rows; at Cout = 256 a 120-pixel row leaves room for
    only two B stages beside the slabs."""
    for w, cout in ((128, 128), (120, 256)):
        x, wt, s = conv_inputs(np.random.default_rng(4), 1, 2, w, 128, cout,
                               cuda)
        reset_launch_counts()
        with pytest.raises(ValueError):
            tq.conv3x3_s8_bitshift(x, wt, s)
        assert launch_counts() == {}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_conv3x3_s8_variants_reject_what_they_cannot_take(cuda, name):
    x = torch.zeros((1, 4, 4, 96), dtype=torch.int8, device=cuda)
    wt = torch.zeros((128, 9 * 96), dtype=torch.int8, device=cuda)
    s = torch.ones(128, device=cuda)
    with pytest.raises(ValueError):
        VARIANTS[name](x, wt, tq.pack_ncat_weight(wt), s, torch.bfloat16,
                       0)
    with pytest.raises(TypeError):
        VARIANTS[name](x.float(), wt, tq.pack_ncat_weight(wt), s,
                       torch.bfloat16, 0)


FLAVORS = {"identity": (128, 128, False, False),
           "down": (256, 512, True, False),
           "ibn": (128, 128, False, True),
           "ibn256": (256, 256, False, True),
           "identity512": (512, 512, False, False),
           "down128": (64, 128, True, False)}
# (flavor, batch, H, W): 9x7 images, several to a tile; then the trunk's
# own geometries at a small batch: block22's 32x16 c128 IBN, whose images
# span two 256-row tiles, block32's 16x8 c256 IBN, one image a tile,
# block41's 16x8 256 -> 512 down and block42's 16x8 c512 identity; and a
# ragged 20x13 whose images exceed a tile (19 rows and 1 row of 13 pixels
# at Cout = 128, 9 + 9 + 2 at 256), the down GEMM's 256-row tiles among
# them (Cout = 128).
BLOCK_CASES = ([(f, 5, 9, 7) for f in ("identity", "down", "ibn", "ibn256")]
               + [("ibn", 3, 32, 16), ("ibn256", 4, 16, 8),
                  ("down", 4, 16, 8), ("identity512", 3, 16, 8),
                  ("ibn", 2, 20, 13), ("ibn256", 2, 20, 13),
                  ("identity", 3, 20, 13), ("down128", 3, 20, 13)])


def block_case(flavor, b, h, w, dtype, seed, dev):
    cin, cout, down, ibn = FLAVORS[flavor]
    rng = np.random.default_rng(seed)
    p = block_params(rng, cin, cout, down, ibn, dev)
    x = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(
        np.float32)).to(dtype).to(dev)
    return x, p, ibn


@pytest.mark.parametrize("flavor,b,h,w", BLOCK_CASES)
def test_se_basic_block_s8_matches_plain(cuda, flavor, b, h, w):
    x, p, ibn = block_case(flavor, b, h, w, torch.bfloat16, 7, cuda)
    reset_launch_counts()
    got = tqb.se_basic_block_s8(x, p, ibn=ibn)
    assert launch_counts()[tqb.NAME] == 1
    want = tqb.se_basic_block_s8_plain(x, p, ibn=ibn)
    torch.cuda.synchronize()
    within(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.parametrize("flavor,b,h,w",
                         [("down", 3, 8, 6), ("ibn", 3, 8, 6),
                          ("ibn", 2, 32, 16), ("down", 3, 16, 8)])
def test_se_basic_block_s8_f32_matches_plain(cuda, flavor, b, h, w):
    x, p, ibn = block_case(flavor, b, h, w, torch.float32, 8, cuda)
    reset_launch_counts()
    got = tqb.se_basic_block_s8(x, p, ibn=ibn, out_dtype=torch.float32)
    assert launch_counts()[tqb.NAME] == 1
    want = tqb.se_basic_block_s8_plain(x, p, ibn=ibn,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    within(got.cpu().numpy(), want.cpu().numpy())


def test_se_basic_block_s8_rejects_float32(cuda):
    p = block_params(np.random.default_rng(0), 128, 128, False, False, cuda)
    x = torch.zeros((1, 4, 4, 128), device=cuda)
    with pytest.raises(TypeError):
        tqb.se_basic_block_s8(x, p)


def test_int8_embed_on_card_matches_cpu(cuda):
    """The card's int8 embed (both kernels and torch._int_mm) against the
    same quantized model on the CPU (plain versions)."""
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils import quantize as tqz

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 64, 32, 3)).astype(np.float32))
    cpu = build_model("seres18", num_classes=16, dtype=torch.bfloat16,
                      device="cpu")
    qs = tqz.quantize(cpu, [x])
    card = build_model("seres18", num_classes=16, dtype=torch.bfloat16,
                       device=cuda)
    card.load_state_dict(cpu.state_dict())
    q_cpu = tqz.quantized_model(cpu, qs)
    q_card = tqz.quantized_model(card, tqz.QuantState(
        {k: v.to(cuda) for k, v in qs.kernels.items()},
        {k: v.to(cuda) for k, v in qs.w_scales.items()}, qs.act_scales))
    reset_launch_counts()
    with torch.no_grad():
        e_c = torch.cat(q_cpu(x.to(torch.bfloat16)), 1).float()
        e_g = torch.cat(q_card(x.to(torch.bfloat16).to(cuda)), 1).float()
    assert launch_counts()[tq.NAME] == 2
    assert launch_counts()[tqb.NAME] == 4
    cos = torch.nn.functional.cosine_similarity(e_c, e_g.cpu(), dim=1)
    assert cos.min() >= 0.999, cos


def test_yolo_int8_detector_on_card_matches_cpu(cuda):
    import copy

    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.models import yolo
    from reid_tpu_torch.utils.quantize import QuantState

    rng = np.random.default_rng(7)
    frame = rng.integers(0, 60, (540, 960, 3), np.uint8)
    for _ in range(20):
        x, y = rng.integers(0, 900), rng.integers(0, 440)
        frame[y:y + 100, x:x + 40] = rng.integers(40, 255, 3)
    det_hw = (288, 512)
    with torch.inference_mode(), full_f32():
        model = yolo.build_yolo("yolov5s", dtype=torch.bfloat16,
                                device=cuda)
        qs = yolo.quantize_yolo(model, frame[None], det_hw)
        cpu_qs = QuantState({k: v.cpu() for k, v in qs.kernels.items()},
                            {k: v.cpu() for k, v in qs.w_scales.items()},
                            dict(qs.act_scales))
        keep_g, keep_c = {}, {}
        reset_launch_counts()
        tg, _, vg = yolo.make_yolo_detector_fn(
            model, det_hw, qstate=qs, keep=keep_g)(frame)
        assert launch_counts()[tq.NAME] == 7
        tc, _, vc = yolo.make_yolo_detector_fn(
            copy.deepcopy(model).cpu(), det_hw, qstate=cpu_qs,
            keep=keep_c)(frame)
    assert vg.sum() == vc.sum() > 0
    scale, _, (py, px) = yolo.letterbox_geometry(frame.shape[:2], det_hw)

    def boxes(cand):
        cand = cand[0].float().cpu().numpy()
        tl = cand[:, :2] - 0.5 * cand[:, 2:4]
        return (np.concatenate([tl, cand[:, 2:4]], 1)
                - [px, py, 0, 0]) * yolo.inv_f32(scale)
    bg, bc = boxes(keep_g["candidates"]), boxes(keep_c["candidates"])
    for box in tg[vg]:
        j = int(np.abs(bg - box).max(1).argmin())
        assert np.abs(bg[j] - box).max() < 1e-3
        assert np.abs(bc[j] - box).max() <= 0.5, (box, bc[j])


def test_smooth_tracklets_on_card_repeats_and_matches_cpu(cuda):
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.ops.camera import smooth_tracklets

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3000, 256)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 400, 3000))
    with full_f32():
        a = smooth_tracklets(x.to(cuda), ids.to(cuda))
        b = smooth_tracklets(x.to(cuda), ids.to(cuda))
        want = smooth_tracklets(x, ids)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), atol=1e-6)


@pytest.fixture
def no_tf32():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = flag


def test_sqeuclidean_topk_block_matches_plain(cuda, no_tf32):
    """A query block of the retrieval path's width (1,024 x 2,000, D =
    1,263) on values that are multiples of 1/4: every product and sum is
    exact in f32, so kernel and plain agree exactly and no near-tie can
    reorder neighbours; the top-20 indices must then be equal on every
    row, which holds every element the tiles, padding and masks move."""
    rng = np.random.default_rng(11)
    x = np.round(rng.normal(size=(1024, 1263)) * 4) / 4
    y = np.round(rng.normal(size=(2000, 1263)) * 4) / 4
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    y = torch.from_numpy(y.astype(np.float32)).to(cuda)
    reset_launch_counts()
    got = tdist.sqeuclidean(x, y)
    assert launch_counts()[tdist.NAME_SQ] == 1
    want = tdist.sqeuclidean_plain(x, y)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    top_g = torch.sort(got, dim=1, stable=True).indices[:, :20]
    top_w = torch.sort(want, dim=1, stable=True).indices[:, :20]
    assert bool((top_g == top_w).all())


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (37, 129, 33),
                                   (300, 1000, 1263), (128, 256, 64),
                                   (1024, 2000, 1263)])
def test_sqeuclidean_matches_plain(cuda, no_tf32, m, n, d):
    rng = np.random.default_rng(m + n + d)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    reset_launch_counts()
    got = tdist.sqeuclidean(x, y)
    assert launch_counts()[tdist.NAME_SQ] == 1
    want = tdist.sqeuclidean_plain(x, y)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (37, 129, 33),
                                   (200, 300, 2100), (128, 256, 64)])
def test_l1_matches_plain(cuda, m, n, d):
    rng = np.random.default_rng(m * n + d)
    x = torch.from_numpy(rng.random((m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((n, d)).astype(np.float32)).to(cuda)
    x, y = x / x.sum(1, keepdim=True), y / y.sum(1, keepdim=True)
    reset_launch_counts()
    got = tdist.l1(x, y)
    assert launch_counts()[tdist.NAME_L1] == 1
    want = tdist.l1_plain(x, y)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_distance_kernels_reject_what_they_cannot_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        tdist.l1(x.double(), x.double())
    with pytest.raises(ValueError):
        tdist.sqeuclidean(x, torch.zeros((4, 9), device=cuda))
    with pytest.raises(ValueError):
        tdist.l1(x.T, x.T)


def test_topk_neighbors_on_card_matches_cpu(cuda):
    """The kernel's ranking against the CPU's plain ranking on clustered
    unit rows; both order ties lowest index first."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(20, 64))
    f = np.repeat(centers, 30, 0) + 0.2 * rng.normal(size=(600, 64))
    f = torch.from_numpy((f / np.linalg.norm(f, axis=1, keepdims=True)
                          ).astype(np.float32))
    d_c, i_c = tdist.topk_neighbors(f, f, k=20, block_q=256)
    d_g, i_g = tdist.topk_neighbors(f.to(cuda), f.to(cuda), k=20,
                                    block_q=256)
    np.testing.assert_allclose(d_g.cpu().numpy(), d_c.numpy(), atol=1e-5)
    assert (i_g.cpu() == i_c).all(1).float().mean() >= 0.99


def test_retrieval_on_card_matches_cpu(cuda):
    """The post-embed half of retrieval (de-bias, Jaccard with both
    kernels, DBSCAN, smoothing, Jaccard, CMC/mAP) on the card against the
    CPU, on the same features: CMC within 1/Q at every rank and mAP within
    1e-2 end to end (neighbours within rounding of each other may swap
    across the k-cuts: chip_smoke.py's `phase_retrieval_cpu` explains), and
    from the same ranking the Jaccard within 1e-5 everywhere."""
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config
    from reid_tpu_torch.eval.inference import evaluate_features
    from reid_tpu_torch.ops import rerank

    class Split:
        def __init__(self, labels, cams):
            self.labels, self.cams = labels, cams
            self.seqs = np.zeros_like(labels)

    rng = np.random.default_rng(4)
    ids = np.arange(300) % 30
    f = rng.normal(size=(30, 96))[ids] + 0.6 * rng.normal(size=(300, 96))
    f = torch.from_numpy(f.astype(np.float32))
    cams = rng.integers(0, 4, 300)
    q, g = Split(ids[:60], cams[:60]), Split(ids[60:], cams[60:])
    out = {}
    with full_f32(), torch.inference_mode():
        for dev in ("cpu", cuda):
            reset_launch_counts()
            res = evaluate_features(f[:60].to(dev), f[60:].to(dev), q, g,
                                    Config(), verbose=False)
            out[str(dev)] = res, launch_counts()
        x = f / f.norm(dim=1, keepdim=True)
        _, rank = tdist.topk_neighbors(x, x, k=20)
        j_c = rerank._jaccard_from_rank(x, rank, 20, 6)
        j_g = rerank._jaccard_from_rank(x.to(cuda), rank.to(cuda), 20, 6)
    (cmc_c, map_c), n_c = out["cpu"]
    (cmc_g, map_g), n_g = out[str(cuda)]
    assert not n_c and n_g[tdist.NAME_SQ] > 0 and n_g[tdist.NAME_L1] > 0
    assert np.abs(cmc_g - cmc_c).max() <= 1 / 60 + 1e-6
    assert abs(map_g - map_c) <= 1e-2
    np.testing.assert_allclose(j_g.cpu().numpy(), j_c.numpy(), atol=1e-5)


def card_int8_embed(dev, crop_hw, seed=0):
    """A random-init int8 SERes18 embed on `dev` (16 classes), calibrated
    on noise: fn(crops) -> L2-normalized [feat || logits]."""
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils import quantize as tqz

    torch.manual_seed(seed)
    model = build_model("seres18", num_classes=16, dtype=torch.bfloat16,
                        device=dev)
    calib = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(8, *crop_hw, 3)).astype(np.float32)).to(dev)
    net = tqz.quantized_model(model, tqz.quantize(model, [calib]))

    def embed(crops):
        f, lg = net(crops.to(torch.bfloat16))
        e = torch.cat([f.float(), lg.float()], 1)
        return e / torch.clamp(e.norm(dim=1, keepdim=True), min=1e-12)
    return embed


def test_int8_streams_on_card_match_single_stream(cuda):
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    from _scenes import build_mot_scene
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.tracking.methods import method_config
    from reid_tpu_torch.tracking.pipeline import make_chunked_tracker
    from reid_tpu_torch.tracking.streams import (init_stream_states,
                                                 make_stream_tracker)
    from reid_tpu_torch.tracking.tracker import init_tracker_state

    crop, n_s, t, chunk = (64, 32), 3, 16, 8
    seqs = [build_mot_scene(t_total=t, n_t=4, max_dets=8, h=120, w=160,
                            seed=s)[:4] for s in range(n_s)]
    data = [torch.from_numpy(np.stack([q[i] for q in seqs])).to(cuda)
            for i in range(4)]
    embed = card_int8_embed(cuda, crop)
    cfg = method_config("strongsort", max_tracks=16, max_dets=8,
                        crop_hw=crop, n_init=2)
    run = make_stream_tracker(cfg, embed, crop, chunk=chunk, device=cuda)
    single = make_chunked_tracker(cfg, embed, crop, chunk=chunk)
    with full_f32(), torch.inference_mode():
        st = init_stream_states(n_s, 16, 528, device=cuda)
        reset_launch_counts()
        outs = []
        for s in range(0, t, chunk):
            st, o = run(st, *[x[:, s:s + chunk] for x in data])
            outs.append(o)
        counts = launch_counts()
        got = {k: torch.cat([o[k] for o in outs], 1).cpu() for k in outs[0]}
        bit_equal = []
        for si in range(n_s):
            one = init_tracker_state(16, 528, device=cuda)
            ref = []
            for s in range(0, t, chunk):
                one, o = single(one, *[x[si, s:s + chunk] for x in data])
                ref.append(o)
            want = {k: torch.cat([o[k] for o in ref]).cpu() for k in ref[0]}
            assert torch.equal(got["valid"][si], want["valid"]), si
            assert torch.equal(got["ids"][si], want["ids"]), si
            v = want["valid"]
            assert v.sum() > 20, si
            np.testing.assert_allclose(got["tlwh"][si][v].numpy(),
                                       want["tlwh"][v].numpy(), atol=1e-4)
            bit_equal.append(all(torch.equal(got[k][si], want[k])
                                 for k in want))
    # one embed call a chunk for all streams: 2 K1 and 4 K2 launches each
    assert counts[tq.NAME] == 2 * (t // chunk), counts
    assert counts[tqb.NAME] == 4 * (t // chunk), counts
    print(f"streams bit-equal to their single-stream runs: {bit_equal}")


def test_int8_artifact_on_card_launches_kernels(cuda, tmp_path):
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             export_reid_artifact,
                                             load_serving_fn, make_embed_fn)
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import quantized_model

    torch.manual_seed(0)
    model = build_model("seres18", num_classes=16, device=cuda)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (5, 64, 32, 3)).astype(np.float32)).to(cuda)
    path = str(tmp_path / "reid_int8.pt2")
    with full_f32():
        qs = calibrate_serving_qstate(model, imgs[:4])
        export_reid_artifact(model, path, 64, 32, qstate=qs)
        loaded = load_serving_fn(path)
        eager = make_embed_fn(quantized_model(model, qs))
        with torch.inference_mode():
            for b in (1, 3, 5):
                want = eager(imgs[:b])
                reset_launch_counts()
                got = loaded(imgs[:b])
                torch.cuda.synchronize()
                counts = launch_counts()
                assert counts[tq.NAME] == 2 and counts[tqb.NAME] == 4, counts
                assert torch.equal(got, want), (b, (got - want).abs().max())


def test_int8_chunk_artifact_on_card(cuda, tmp_path):
    """The int8 tracking chunk exported with torch.export
    (`pipeline.chunk_serving_fn`) and reloaded: its two chunks launch K1
    and K2 (2 and 4 a chunk, one embed call each) and equal the eager
    chunk's ids and valid, tlwh within 1e-4."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    from _scenes import build_mot_scene
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.tracking.methods import method_config
    from reid_tpu_torch.tracking.pipeline import (chunk_serving_fn,
                                                  make_chunked_tracker)
    from reid_tpu_torch.tracking.tracker import init_tracker_state
    from reid_tpu_torch.utils.export import (export_serving_fn,
                                             load_serving_fn)

    crop, t, chunk = (64, 32), 16, 8
    data = [torch.from_numpy(x).to(cuda) for x in build_mot_scene(
        t_total=t, n_t=4, max_dets=8, h=120, w=160, seed=0)[:4]]
    cfg = method_config("strongsort", max_tracks=16, max_dets=8,
                        crop_hw=crop, n_init=2)
    serving = chunk_serving_fn(make_chunked_tracker(
        cfg, card_int8_embed(cuda, crop), crop, chunk=chunk))
    state = tuple(init_tracker_state(16, 528, device=cuda))
    chunks = [tuple(x[s:s + chunk] for x in data)
              for s in range(0, t, chunk)]
    path = str(tmp_path / "chunk.pt2")
    with full_f32():
        export_serving_fn(serving, state + chunks[0], path,
                          dynamic_batch=False)
        loaded = load_serving_fn(path)
        with torch.inference_mode():
            runs = []
            for fn in (serving, loaded):
                st, outs = state, []
                reset_launch_counts()
                for c in chunks:
                    res = fn(*st, *c)
                    st, outs = res[:len(state)], outs + [res[len(state):]]
                torch.cuda.synchronize()
                runs.append((outs, launch_counts()))
    (want, _), (got, counts) = runs
    assert counts[tq.NAME] == 2 * len(chunks), counts
    assert counts[tqb.NAME] == 4 * len(chunks), counts
    for (tl, ids, vd), (wtl, wids, wvd) in zip(got, want):
        assert torch.equal(vd, wvd) and torch.equal(ids, wids)
        assert float((tl[wvd] - wtl[wvd]).abs().max()) <= 1e-4
    assert sum(int(w[2].sum()) for w in want) > 20


def _train_setup(c, b, hw):
    """Flax variables of a seeded SERes18, unit DCC table rows, a uint8
    batch of b // 4 ids x 4 and its augmentation draws, all on the host."""
    from reid_tpu_torch.data.transforms import augment_draws
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flax_variables

    variables = flax_variables(build_model(
        "seres18", c, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    lut = rng.normal(size=(2, c, c)).astype(np.float32)
    lut /= np.linalg.norm(lut, axis=2, keepdims=True)
    images = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    labels = np.repeat(np.arange(b // 4) * 3, 4).astype(np.int32)
    draws = augment_draws(torch.Generator().manual_seed(1), b, *hw,
                          device="cpu")
    return variables, lut, images, labels, draws


def _train_state(dev, dtype, variables, lut, cfg):
    from reid_tpu_torch.losses import DCCState
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.train.state import create_train_state
    from reid_tpu_torch.utils.flax_bridge import load_flax_variables

    model = build_model("seres18", cfg.model.num_classes, dtype=dtype,
                        device=dev)
    load_flax_variables(model, variables)
    state = create_train_state(model, cfg, 100,
                               torch.Generator().manual_seed(2))
    state.loss_state = state.loss_state._replace(dcc=DCCState(
        *(torch.from_numpy(t).to(dev) for t in lut)))
    return state


def test_train_step_bf16_on_card_is_finite(cuda):
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.train.steps import make_train_step

    cfg = Config(model=ModelConfig(num_classes=32),
                 train=TrainConfig(batch_size=16, num_instances=4))
    variables, lut, images, labels, _ = _train_setup(32, 16, (256, 128))
    state = _train_state(cuda, torch.bfloat16, variables, lut, cfg)
    step = make_train_step(cfg, generator=torch.Generator(cuda)
                           .manual_seed(0))
    batch = {"images": torch.from_numpy(images).to(cuda),
             "labels": torch.from_numpy(labels).to(cuda)}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
    assert np.all(np.isfinite(losses)) and state.step == 2
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())
    for t in state.loss_state.dcc:
        norms = t.norm(dim=1)
        assert bool(torch.isfinite(t).all())
        assert torch.allclose(norms[labels[::4]], torch.ones(4, device=cuda),
                              atol=1e-5)


def test_train_step_on_card_makes_no_host_sync(cuda):
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.train.steps import make_train_step

    cfg = Config(model=ModelConfig(num_classes=32),
                 train=TrainConfig(batch_size=16, num_instances=4))
    variables, lut, images, labels, _ = _train_setup(32, 16, (256, 128))
    state = _train_state(cuda, torch.bfloat16, variables, lut, cfg)
    step = make_train_step(cfg, generator=torch.Generator(cuda)
                           .manual_seed(0))
    batch = {"images": torch.from_numpy(images).to(cuda),
             "labels": torch.from_numpy(labels).to(cuda)}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(m["loss"])) and state.step == 3


def test_train_step_f32_on_card_matches_cpu(cuda):
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.train.steps import make_train_step

    cfg = Config(model=ModelConfig(num_classes=16, dtype="float32"),
                 train=TrainConfig(batch_size=8, num_instances=4))
    variables, lut, images, labels, draws = _train_setup(16, 8, (64, 32))
    out = {}
    with full_f32():
        for dev in ("cpu", cuda):
            state = _train_state(dev, torch.float32, variables, lut, cfg)
            start = [p.detach().clone() for p in state.model.parameters()]
            state, m = make_train_step(cfg)(state, {
                "images": torch.from_numpy(images).to(dev),
                "labels": torch.from_numpy(labels).to(dev),
                "aug_draws": {k: v.to(dev) for k, v in draws.items()}})
            out[str(dev)] = (float(m["loss"]), torch.cat([
                (p.detach() - s).ravel() for p, s in zip(
                    state.model.parameters(), start)]).cpu().double(),
                [t.cpu() for t in state.model.buffers()]
                + [state.loss_state.centers.cpu()]
                + [t.cpu() for t in state.loss_state.dcc])
    (l_c, u_c, t_c), (l_g, u_g, t_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c)
    assert float(u_g @ u_c / (u_g.norm() * u_c.norm())) >= 0.9995
    assert float((u_g - u_c).norm()) <= 0.03 * float(u_c.norm())
    for a, b in zip(t_g, t_c):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_grouped_int8_conv_on_card_matches_cpu(cuda):
    from reid_tpu_torch.models.layers import Conv2d
    from reid_tpu_torch.utils.quantize import QConv2d, grouped_acc
    gen = torch.Generator().manual_seed(0)
    conv = Conv2d(64, 64, 3, padding=1, dtype=torch.bfloat16,
                  keep_f32=True, groups=64)
    conv.reset_parameters(gen)
    kq = torch.randint(-127, 128, (64, 1, 3, 3), generator=gen,
                       dtype=torch.int8)
    sw = torch.rand(64, generator=gen) * 1e-2 + 1e-3
    q_cpu = QConv2d(conv, kq, sw, 0.05)
    q_card = QConv2d(conv, kq.to(cuda), sw.to(cuda), 0.05).to(cuda)
    x = torch.randn((16, 32, 16, 64), generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        want = q_cpu(x)
        got = q_card(x.to(cuda)).cpu()
    assert torch.equal(got, want)
    xq = torch.full((1, 4, 4, 64), 127, dtype=torch.int8, device=cuda)
    wq = torch.full((64, 1, 3, 3), -127, dtype=torch.int8, device=cuda)
    assert float(grouped_acc(xq, wq, 1, 1, 64)[0, 1, 1, 0]) == \
        -9 * 127 * 127


@pytest.mark.parametrize("instances", [0, 4])
def test_plr_train_step_on_card_makes_no_host_sync(cuda, instances):
    from reid_tpu_torch.config import (Config, ModelConfig, TrainConfig)
    from reid_tpu_torch.train.optim import Madgrad
    from reid_tpu_torch.train.plr_train import (create_plr_train_state,
                                                make_plr_train_step)
    cfg = Config(model=ModelConfig(backbone="plr_osnet", num_classes=8,
                                   dtype="bfloat16"),
                 train=TrainConfig(batch_size=16, num_instances=instances))
    state = create_plr_train_state(cfg, 10, device="cuda")
    assert isinstance(state.tx, Madgrad) == (instances == 0)
    step = make_plr_train_step(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"images": torch.randn((16, 256, 128, 3), generator=gen,
                                   device=cuda),
             "labels": torch.arange(16, device=cuda) // 2 % 8}
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 3
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert all(bool(torch.isfinite(p).all()) for p in state.params())


TRANSFORMER_KW = {
    "vit": (dict(dim=64, depth=2, heads=4, mlp_dim=128), (128, 64)),
    "swin_v2": (dict(hidden_dim=16, layers=(2, 2, 2, 2), heads=(1, 2, 2, 4),
                     head_dim=8, window_size=2), (64, 64)),
}


@pytest.mark.parametrize("name", list(TRANSFORMER_KW))
def test_transformer_embeds_on_card_match_cpu(cuda, name):
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils import quantize as tqz

    kw, hw = TRANSFORMER_KW[name]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, *hw, 3)).astype(np.float32)).to(torch.bfloat16)
    cpu = build_model(name, num_classes=16, dtype=torch.bfloat16,
                      device="cpu", input_hw=hw, **kw)
    card = build_model(name, num_classes=16, dtype=torch.bfloat16,
                       device=cuda, input_hw=hw, **kw)
    card.load_state_dict(cpu.state_dict())
    qs = tqz.quantize(cpu, [x])
    q_cpu = tqz.quantized_model(cpu, qs)
    q_card = tqz.quantized_model(card, tqz.QuantState(
        {k: v.to(cuda) for k, v in qs.kernels.items()},
        {k: v.to(cuda) for k, v in qs.w_scales.items()}, qs.act_scales))
    reset_launch_counts()
    with torch.no_grad():
        for m_c, m_g in ((cpu, card), (q_cpu, q_card)):
            e_c = torch.cat(m_c(x), 1).float()
            e_g = torch.cat(m_g(x.to(cuda)), 1).float().cpu()
            cos = torch.nn.functional.cosine_similarity(e_c, e_g, dim=1)
            assert cos.min() >= 0.999, cos
    assert launch_counts().get(tq.NAME, 0) == 0
    assert launch_counts().get(tqb.NAME, 0) == 0


def _transformer_step(cuda, seed, instances=4):
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.train.state import create_train_state
    from reid_tpu_torch.train.steps import make_train_step

    kw, hw = TRANSFORMER_KW["vit"]
    cfg = Config(model=ModelConfig(backbone="vit", num_classes=8,
                                   feat_dim=64),
                 train=TrainConfig(batch_size=16, num_instances=instances))
    model = build_model("vit", num_classes=8, dtype=torch.bfloat16,
                        device=cuda, input_hw=hw, **kw)
    state = create_train_state(model, cfg, 10,
                               torch.Generator().manual_seed(0))
    step = make_train_step(cfg, generator=torch.Generator(cuda)
                           .manual_seed(seed))
    gen = torch.Generator(cuda).manual_seed(1)
    batch = {"images": torch.randn((16, *hw, 3), generator=gen,
                                   device=cuda),
             "labels": torch.arange(16, device=cuda) // 4,
             "cams": torch.arange(16, device=cuda) % 6}
    return state, step, batch


@pytest.mark.parametrize("instances", [4, 0])
def test_transformer_train_step_on_card_makes_no_host_sync(cuda, instances):
    """Plain SGD under PK sampling and Adam without it (the DCC table's
    rounds bounded by the batch, not read from the labels)."""
    state, step, batch = _transformer_step(cuda, 0, instances)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 3 and np.isfinite(float(m["loss"]))
    assert all(bool(torch.isfinite(p).all()) for p in state.params())


def test_transformer_train_step_on_card_repeats(cuda):
    out = []
    for seed in (0, 0, 1):
        state, step, batch = _transformer_step(cuda, seed)
        step(state, batch)
        out.append(torch.cat([p.detach().ravel() for p in state.params()]))
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], out[2])


def _video_state(dev, dtype):
    from reid_tpu_torch.models.video3d import VideoResNet
    from reid_tpu_torch.train.video_train import create_video_train_state
    model = VideoResNet(num_classes=8, blocks=(1, 1, 1, 1), dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(0))
    return create_video_train_state(model.to(dev), 8,
                                     torch.Generator().manual_seed(1))


def test_video_train_step_on_card_makes_no_host_sync(cuda):
    """The video step (bf16, MADGRAD without a clip, the centers' step)
    after two warm-up steps reads nothing back and copies nothing from
    the host; its loss and parameters are finite."""
    from reid_tpu_torch.config import Config
    from reid_tpu_torch.train.video_train import make_video_train_step
    state = _video_state(cuda, torch.bfloat16)
    step = make_video_train_step(Config())
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"images": torch.rand((4, 4, 64, 32, 3), generator=gen,
                                  device=cuda),
             "labels": torch.arange(4, device=cuda, dtype=torch.int32) // 2}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.opt_state["count"] == 3 and np.isfinite(float(loss))
    assert all(bool(torch.isfinite(p).all()) for p in state.params())


def test_video_forward_on_card_matches_cpu(cuda):
    """VideoResNet(blocks=(1, 1, 1, 1)) in eval mode on 2 clips of 4 x 64
    x 32: f32 (TF32 off inside the 3-D convs) within rtol = atol = 1e-4
    of the CPU; bf16 at a cosine >= 0.999 a row."""
    from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                                  load_flax_variables)
    x = torch.rand((2, 4, 64, 32, 3),
                   generator=torch.Generator().manual_seed(2))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = _video_state("cpu", dtype).model
        card = _video_state(cuda, dtype).model
        load_flax_variables(card, flax_variables(cpu))
        with torch.no_grad():
            want = cpu(x)
            got = card(x.to(cuda))
        for g, w in zip(got, want):
            g, w = g.float().cpu(), w.float()
            if dtype == torch.float32:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                           atol=1e-4)
            else:
                cos = torch.nn.functional.cosine_similarity(g, w, dim=1)
                assert float(cos.min()) >= 0.999, cos


@pytest.fixture
def tf32_off():
    """TF32 off for matmuls and cuDNN's convolutions (f32 against the
    CPU's f32)."""
    from reid_tpu_torch.cli import full_f32
    with full_f32():
        yield


def _gan_states(dev, kind):
    """A seeded DCGAN (spectral, nz 16, ngf = ndf = 16) or VAE-GAN (the
    VAE, zdim 16, and a Wasserstein D with the VAE head, ndf 8) state on
    `dev` and its step."""
    from reid_tpu_torch.gan import models, train as gtrain
    from reid_tpu_torch.train.optim import Adam
    if kind == "dcgan":
        gen = models.Generator(nz=16, ngf=16).init_weights(
            torch.Generator().manual_seed(0))
        disc = models.Discriminator(ndf=16).init_weights(
            torch.Generator().manual_seed(1))
        state, g_tx, d_tx = gtrain.create_gan_state(gen.to(dev),
                                                    disc.to(dev))
        state.step = 2                      # G's update and the EMA follow
        return state, gtrain.make_dcgan_steps(g_tx, d_tx)
    vae = models.VAE(zdim=16).init_weights(torch.Generator().manual_seed(0))
    disc = models.Discriminator(ndf=8, spectral=False, vae=True,
                                wasserstein=True).init_weights(
                                    torch.Generator().manual_seed(1))
    init, step = gtrain.make_vaegan_steps(Adam(2e-4, b1=0.5),
                                          Adam(2e-4, b1=0.5),
                                          wasserstein=True)
    return init(vae.to(dev), disc.to(dev)), step


def _gan_args(kind, dev):
    g = torch.Generator().manual_seed(2)
    real = torch.rand((4, 128, 64, 3), generator=g) * 2 - 1
    if kind == "dcgan":
        extra = (torch.randn((4, 16), generator=g),
                 torch.randn((4, 16), generator=g))
    else:
        extra = (torch.randn((4, 16), generator=g),
                 torch.rand((4, 1, 1, 1), generator=g))
    return [t.to(dev) for t in (real, *extra)]


def _modules(state):
    if hasattr(state, "vae"):
        return state.vae, state.discriminator, state.vae_opt, state.d_opt
    return (state.generator, state.discriminator, state.g_opt,
            state.d_opt)


@pytest.mark.parametrize("kind", ["dcgan", "vaegan_gp"])
def test_gan_step_on_card_matches_cpu(cuda, tf32_off, kind):
    out = {}
    for dev in ("cpu", cuda):
        state, step = _gan_states(dev, kind)
        state, m = step(state, *_gan_args(kind, dev))
        a, b, oa, ob = _modules(state)
        out[str(dev)] = (sum(float(v) for v in m.values()),
                         torch.cat([t.detach().double().cpu().ravel()
                                    for t in oa["mu"] + ob["mu"]]),
                         [t.cpu() for t in list(a.buffers())
                          + list(b.buffers())])
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    assert float((gg - gc).norm() / gc.norm()) <= 1e-3
    for x, y in zip(sg, sc):
        scale = max(float(y.abs().max()), 1e-30)
        assert float((x - y).abs().max()) <= 1e-3 * scale


@pytest.mark.parametrize("kind", ["dcgan", "vaegan_gp"])
def test_gan_step_on_card_makes_no_host_sync(cuda, kind):
    state, step = _gan_states(cuda, kind)
    args = _gan_args(kind, cuda)
    for _ in range(2):
        step(state, *args)
    torch.cuda.synchronize()
    if kind == "dcgan":
        state.step = 5                  # a G step, with the EMA
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(np.isfinite(float(v)) for v in m.values())


def _detector_data():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (4, 96, 160, 3), np.uint8)
    xy = rng.uniform(0, 100, (4, 5, 2))
    tlwh = np.concatenate([xy, rng.uniform(8, 40, (4, 5, 2))], -1)
    return frames, tlwh.astype(np.float32), np.ones((4, 5), bool)


def test_train_detector_on_card_matches_cpu(cuda, tf32_off):
    from reid_tpu_torch.train.detector_train import train_detector
    out = {}
    for dev in ("cpu", cuda):
        model, v, losses = train_detector(
            *_detector_data(), det_hw=(64, 128), epochs=1, batch_size=4,
            base=8, log_fn=lambda *_: None, device=dev)
        out[str(dev)] = (losses[0], torch.cat([
            p.detach().double().cpu().ravel() for p in model.parameters()]),
            [b.cpu() for b in model.buffers()])
    (lc, pc, sc), (lg, pg, sg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    for x, y in zip(sg, sc):
        assert float((x - y).abs().max()) <= 1e-3 * float(y.abs().max())


def test_detector_step_on_card_makes_no_host_sync(cuda):
    from reid_tpu_torch.models.detector import (CenterNetLite,
                                                detection_loss,
                                                make_centernet_targets)
    from reid_tpu_torch.tracking.pipeline import resize_bilinear_matmul
    from reid_tpu_torch.train.optim import Adam
    model = CenterNetLite(base=8).init_weights(
        torch.Generator().manual_seed(0)).to(cuda)
    params = list(model.parameters())
    tx = Adam(1e-3)
    opt = tx.init(params)
    frames, tlwh, valid = (torch.from_numpy(a).to(cuda)
                           for a in _detector_data())

    def step():
        x = resize_bilinear_matmul(frames.to(torch.float32) / 255.0,
                                   (64, 128))
        loss = detection_loss(model(x, train=True), *make_centernet_targets(
            tlwh * 0.8, valid, (64, 128)))
        tx.apply(params, torch.autograd.grad(loss, params), opt)
        return loss
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(float(loss.detach()))


def test_lsro_baseline_on_card_matches_cpu(cuda, tf32_off):
    """One SGD step of `train_lsro_baseline` (baseline at 128x64, 12 real
    and 4 generated images): the loss within 1e-4 relative and the
    update (-lr g) within 1e-3 of its norm, or twice the CPU's spread
    between its two convolution algorithms where that is wider (the
    train-mode norms over 16 images amplify each convolution's order)."""
    from reid_tpu_torch.gan.driver import train_lsro_baseline
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.flax_bridge import flatten, flax_variables
    rng = np.random.default_rng(4)
    real = rng.integers(0, 255, (12, 128, 64, 3), np.uint8)
    gen = rng.integers(0, 255, (4, 128, 64, 3), np.uint8)
    start = flatten(flax_variables(build_model(
        "baseline", 4, device="cpu",
        generator=torch.Generator().manual_seed(0)))["params"])
    out = {}
    for run, dev, mkldnn in (("cpu", "cpu", True), ("card", cuda, True),
                             ("aten", "cpu", False)):
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            v, hist = train_lsro_baseline(real, np.arange(12) % 4, gen, 4,
                                          epochs=1, batch_size=16,
                                          log_fn=lambda *_: None, device=dev)
        p = flatten(v["params"])
        out[run] = (hist[0]["loss"], np.concatenate(
            [(p[k] - start[k]).ravel() for k in sorted(start)]))
    (lc, uc), (lg, ug), (_, ua) = out["cpu"], out["card"], out["aten"]
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    spread = np.linalg.norm(ua - uc) / np.linalg.norm(uc)
    rel = np.linalg.norm(ug - uc) / np.linalg.norm(uc)
    assert rel <= max(1e-3, 2 * spread), (rel, spread)


def test_sharded_jaccard_world1_on_card_matches_dense(cuda):
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.ops.rerank import (compute_jaccard_distance,
                                           compute_jaccard_distance_sharded)
    f = torch.randn((512, 64), generator=torch.Generator().manual_seed(0))
    with full_f32():
        want = compute_jaccard_distance(f.to(cuda), 20, 6)
        reset_launch_counts()
        got = compute_jaccard_distance_sharded(None, f.to(cuda), 20, 6)
        counts = launch_counts()
    assert torch.equal(got, want)
    assert counts.get("l1", 0) == 1 and counts.get("sqeuclidean", 0) >= 1


def test_train_cnn_nccl_world1_matches_one_device(cuda):
    import copy
    import socket

    import reid_tpu_torch.config as tcfg
    from reid_tpu_torch.data.dataset import synthetic_dataset
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.parallel import default_mesh, init_distributed
    from reid_tpu_torch.train.image_train import train_cnn
    from reid_tpu_torch.train.state import create_train_state

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device="cuda")
    det = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        mesh = default_mesh()
        cfg = tcfg.Config(
            model=tcfg.ModelConfig(num_classes=4, dtype="float32"),
            train=tcfg.TrainConfig(batch_size=8, num_instances=2, epochs=1),
            data=tcfg.DataConfig(height=64, width=32))
        ds = synthetic_dataset(n=24, num_pids=4, height=64, width=32)
        gen = torch.Generator().manual_seed(0)
        model = build_model("seres18", num_classes=4, dtype=torch.float32,
                            device="cuda", generator=gen)
        state = create_train_state(model, cfg, 3, gen)
        out = [train_cnn(cfg, ds, state=copy.deepcopy(state), log_every=1,
                         device="cuda", ckpt_dir=f"/tmp/_w1_{m is None}",
                         mesh=m) for m in (None, mesh)]
    finally:
        torch.backends.cudnn.deterministic = det
        torch.distributed.destroy_process_group()
    (a, la), (b, lb) = out
    assert len(la) == 3 and la == lb, (la, lb)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_deeplab_and_segunet_on_card_match_cpu(cuda):
    import copy

    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.data.segmentation import SegUNet, batched_extraction
    from reid_tpu_torch.models.deeplab import DeepLabV3

    x = torch.rand((2, 64, 48, 3), generator=torch.Generator().manual_seed(1))
    for model, fn in ((DeepLabV3(21, 8, 32), lambda m, t: m(t)),
                      (SegUNet(base=8), lambda m, t: batched_extraction(
                          m, t * 255.0))):
        model = model.init_weights(torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode():
            want = fn(model, x)
            with full_f32():
                got = fn(copy.deepcopy(model).to(cuda), x.to(cuda)).cpu()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
