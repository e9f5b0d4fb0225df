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
                                   (1, 12, 20, 256, 256)])
def test_conv3x3_s8_matches_plain(cuda, shape):
    """Exact in bf16 and f32, one launch each. The shapes cover a tile of
    four whole images (8x4: 32 pixels an image) with Cout split over two
    N tiles of 256, ragged boxes that leave tile rows unused (5x7, 9x11,
    6x10), every tile form (128 x 256 and 256 x 128, K steps of 64 and 128
    channels), one image per tile (16x8), and the YOLOv5s detector's
    call sites, one image a call: at --det_size 288 512 (18x32 with 128
    channels, whose last box holds 2 of its 8 rows; 9x16 with 256, 1 of
    8) and at 384 640 (24x40 and 12x20: box widths of no power of two)."""
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
