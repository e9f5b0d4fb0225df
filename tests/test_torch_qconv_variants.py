"""K3 `conv3x3_s8_ncat`, K4 `conv3x3_s8_bitshift` and K5 `conv3x3_s8_dma`:
the port's plain version of each against the JAX package's kernel of the
same formulation on the same int8 inputs (the Pallas kernel in interpret
mode, one image a grid step, f32 out): equal, since the s32 sums are exact
and the rescale is one f32 multiply. Then, at real widths, all three
against the JAX oracle `conv3x3_s8_reference` in f32 and bf16 (bf16 rounds
the same f32 values to nearest even); the image-block invariance of the K3
and K5 plain versions; the ncat weight packing and its channel groups; the
card's tile plans of K3-K5 (every output pixel covered once, at small
shapes and at the trunk's; K4's slab boxes and B ring within the block's
shared memory, and a row too wide refused) and a pure-torch emulation of
each kernel's tile walk, fed by the wrapper's plan, equal to
`conv3x3_s8_plain` bit for bit;
the probe's CPU run; and that a CPU tensor launches nothing. The CUDA
kernels against their plain versions are in test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.ops import qconv as jq
from reid_tpu_torch import qconv_probe
from reid_tpu_torch.ops import launch_counts, reset_launch_counts
from reid_tpu_torch.ops import qconv as tq

from test_torch_qconv import inputs, pack_hwio
from test_torch_train_data import two_torch_threads  # noqa: F401

JAX_KERNELS = {tq.NCAT: jq.conv3x3_s8_ncat,
               tq.BITSHIFT: jq.conv3x3_s8_bitshift,
               tq.DMA: jq.conv3x3_s8_dma}


def port(name, x, wt, scale, out_dtype=torch.float32, img_block=0):
    """The port's entry point `name` on K1's packed weight."""
    if name == tq.NCAT:
        return tq.conv3x3_s8_ncat(x, tq.pack_ncat_weight(wt), scale,
                                  img_block, out_dtype)
    if name == tq.DMA:
        return tq.conv3x3_s8_dma(x, wt, scale, img_block, out_dtype)
    return tq.conv3x3_s8_bitshift(x, wt, scale, out_dtype)


@pytest.mark.parametrize("name", list(JAX_KERNELS))
@pytest.mark.parametrize("shape", [(2, 5, 4, 8, 8), (4, 4, 4, 8, 16)])
def test_plain_matches_jax_kernel(name, shape):
    x, wq, scale = inputs(np.random.default_rng(sum(shape)), *shape)
    want = JAX_KERNELS[name](jnp.asarray(x), jnp.asarray(wq),
                             jnp.asarray(scale), img_block=1,
                             out_dtype=jnp.float32, interpret=True)
    got = port(name, torch.from_numpy(x), pack_hwio(wq),
               torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def real_width():
    """(1, 4, 4, 64, 128) inputs and the JAX oracle's f32 and bf16 outputs."""
    x, wq, scale = inputs(np.random.default_rng(7), 1, 4, 4, 64, 128)
    args = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale))
    return (x, wq, scale,
            np.asarray(jq.conv3x3_s8_reference(*args, out_dtype=jnp.float32)),
            np.asarray(jq.conv3x3_s8_reference(*args), np.float32))


@pytest.mark.parametrize("name", list(JAX_KERNELS))
def test_plain_matches_jax_reference_at_real_width(name, real_width):
    x, wq, scale, want32, want16 = real_width
    args = (torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale))
    np.testing.assert_array_equal(port(name, *args).numpy(), want32)
    got16 = port(name, *args, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want16)


@pytest.mark.parametrize("name", [tq.NCAT, tq.DMA])
def test_plain_img_block_invariance(name):
    x, wq, scale = inputs(np.random.default_rng(1), 4, 4, 4, 8, 8)
    args = (torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale))
    outs = [port(name, *args, img_block=blk) for blk in (1, 2, 4, 3)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert torch.equal(outs[0], tq.conv3x3_s8_plain(*args, torch.float32))


def test_pack_ncat_weight_roundtrip():
    wt = torch.randint(-127, 128, (24, 9 * 16), dtype=torch.int8)
    wn = tq.pack_ncat_weight(wt)
    assert wn.shape == (9 * 24, 16)
    # row t*Cout + o holds tap t of output channel o
    assert torch.equal(wn[5 * 24 + 7], wt[7, 5 * 16:6 * 16])
    assert torch.equal(tq.unpack_ncat_weight(wn), wt)


def test_img_block_for():
    # an explicit block is kept, capped at the batch
    assert tq.img_block_for(10, 4, 4, 100, 3) == 3
    assert tq.img_block_for(10, 4, 4, 100, 30) == 10
    # auto: as many images as fit the scratch budget
    per_img = 32 * 16 * 4 * 9 * 128
    assert tq.img_block_for(2048, 32, 16, 4 * 9 * 128) == \
        tq.SCRATCH_BYTES // per_img


def test_probe_runs_plain_versions_on_cpu(capsys):
    res = qconv_probe.run([("tiny", 2, 4, 4, 64, 128),
                           ("odd", 3, 5, 3, 64, 128)], device="cpu")
    assert [r["config"] for r in res] == ["tiny", "odd"]
    for r in res:
        assert [row["name"] for row in r["rows"]] == list(
            qconv_probe.KERNELS)
        assert all(row["plain_exact"] for row in r["rows"])
        assert not any("ms" in row for row in r["rows"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_cpu_tensor_takes_plain_version_without_launch():
    x, wq, scale = inputs(np.random.default_rng(0), 1, 4, 4, 64, 128)
    args = (torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale))
    reset_launch_counts()
    for name in JAX_KERNELS:
        port(name, *args)
    assert launch_counts() == {}


def test_ncat_group_weight_roundtrip():
    """An N tile of K3 holds all nine taps of 16 output channels: group
    row t*16 + j is tap t of channel 16*group + j, read from `wn`."""
    wt = torch.randint(-127, 128, (48, 9 * 64), dtype=torch.int8)
    wn = tq.pack_ncat_weight(wt)
    grouped = tq.ncat_group_weight(wn)
    assert grouped.shape == (3, 9, 16, 64)
    assert torch.equal(grouped[2, 5, 7], wt[2 * 16 + 7, 5 * 64:6 * 64])
    assert torch.equal(grouped[1, 0, 3], wn[0 * 48 + 16 + 3])
    # back to wn's rows and to K1's packing
    back = grouped.transpose(0, 1).reshape(9 * 48, 64)
    assert torch.equal(back, wn)
    assert torch.equal(tq.unpack_ncat_weight(back.contiguous()), wt)


def ncat_box(plan, b, h, w, mt):
    """Tile mt's 128 box rows, as the kernel decodes them: each row's
    pixel (n, y, x), whether it lies in the tensor (else TMA zero-fills
    it) and whether it is an output row (`wg::out_row`)."""
    r = torch.arange(tq.NCAT_BM)
    bw, bh, bn, halo = plan["bw"], plan["bh"], plan["bn"], plan["halo"]
    y0 = (mt % plan["tiles_y"]) * plan["step_y"]
    n0 = (mt // plan["tiles_y"]) * bn
    xs, yb, n = r % bw, (r // bw) % bh, n0 + r // (bw * bh)
    y = y0 - halo + yb
    used = r < bw * bh * bn
    inside = used & (y >= 0) & (y < h) & (n < b)
    is_out = inside & (yb >= halo) & (yb < bh - halo)
    return n, y, xs, inside, is_out


def flat_tile(plan, b, h, w, mt):
    """K5 tile mt's rows: bm consecutive flat output pixels."""
    m = mt * plan["bm"] + torch.arange(plan["bm"])
    return m, m < b * h * w


@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 8, 4), (3, 20, 16),
                                   (2, 32, 16), (1, 4, 42), (7, 3, 3),
                                   (2048, 32, 16), (2048, 16, 8),
                                   (512, 8, 4)])
@pytest.mark.parametrize("img_block", [0, 1])
def test_ncat_plan_covers_every_pixel_once(shape, img_block):
    b, h, w = shape
    plan = tq.ncat_plan(b, h, w, img_block)
    hits = torch.zeros(b * h * w, dtype=torch.int64)
    for mt in range(plan["tiles_m"]):
        n, y, xs, _, is_out = ncat_box(plan, b, h, w, mt)
        hits.index_add_(0, ((n * h + y) * w + xs)[is_out],
                        torch.ones(int(is_out.sum()), dtype=torch.int64))
    assert bool((hits == 1).all())
    assert plan["bn"] <= (img_block or b)
    if h * w > tq.NCAT_BM:  # the halo rows above and below each box
        assert plan["halo"] == 1 and plan["bh"] * w <= tq.NCAT_BM
    share = 1 - b * h * w / (plan["tiles_m"] * tq.NCAT_BM)
    assert plan["recomputed"] == pytest.approx(share)


def test_ncat_plan_at_the_trunk_shapes():
    """block21 (32x16): 8-row boxes of 6 output rows, a third of the
    rows recomputed; block31 (16x8) one image and fc-stage4 (8x4) four
    images a box, no halo."""
    p21 = tq.ncat_plan(2048, 32, 16)
    assert (p21["bh"], p21["step_y"], p21["tiles_y"]) == (8, 6, 6)
    assert p21["recomputed"] == pytest.approx(1 / 3)
    assert tq.ncat_plan(2048, 16, 8)["recomputed"] == 0.0
    assert tq.ncat_plan(512, 8, 4)["bn"] == 4
    assert tq.ncat_plan(512, 8, 4)["recomputed"] == 0.0


def test_ncat_plan_rejects_a_row_too_wide():
    with pytest.raises(ValueError):
        tq.ncat_plan(1, 4, 64)
    # an image that fits one box whole needs no halo rows
    assert tq.ncat_plan(1, 1, 100)["halo"] == 0


@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 20, 16), (2048, 32, 16),
                                   (512, 8, 4), (3, 5, 7)])
def test_dma_plan_covers_every_pixel_once(shape):
    b, h, w = shape
    for cout in (128, 256):
        plan = tq.dma_plan(b, h, w, cout)
        assert plan["bm"] == (128 if cout == 256 else 256)
        hits = torch.zeros(b * h * w, dtype=torch.int64)
        for mt in range(plan["tiles_m"]):
            m, ok = flat_tile(plan, b, h, w, mt)
            hits[m[ok]] += 1
        assert bool((hits == 1).all())


def emulate_ncat(x, wn, scale, out_dtype, img_block=0):
    """K3's tile walk on the card, in torch: for each box of the plan and
    each channel group, P = box rows @ group weight (K = Cin, N = 9 x 16);
    then, as the kernel's epilogue sums, first along x for every box row,
    Q_dy[r] = sum over dx of mask_dx(r) * P[r + dx, tap (dy, dx)], then
    along y for each output row, out[r] = sum over dy of mask_dy(r) *
    Q_dy[r + dy * W]."""
    b, h, w, cin = x.shape
    cout, g = wn.shape[0] // 9, tq.NCAT_GROUP
    plan = tq.ncat_plan(b, h, w, img_block)
    groups = tq.ncat_group_weight(wn).reshape(cout // g, 9 * g, cin).to(
        torch.float64)
    out = torch.zeros((b * h * w, cout), dtype=out_dtype)
    written = torch.zeros((b * h * w, cout), dtype=torch.int64)
    r = torch.arange(tq.NCAT_BM)
    for mt in range(plan["tiles_m"]):
        n, y, xs, inside, is_out = ncat_box(plan, b, h, w, mt)
        a = torch.zeros((tq.NCAT_BM, cin), dtype=torch.float64)
        a[inside] = x[n[inside], y[inside], xs[inside]].to(torch.float64)
        for grp in range(cout // g):
            p = (a @ groups[grp].T).to(torch.int64)
            q = torch.zeros((3, tq.NCAT_BM, g), dtype=torch.int64)
            for t, (dy, dx) in enumerate(tq._TAPS):
                ok = (xs + dx >= 0) & (xs + dx < w)
                src = (r + dx).clamp(0, tq.NCAT_BM - 1)
                q[dy + 1][ok] += p[src[ok], t * g:(t + 1) * g]
            acc = torch.zeros((tq.NCAT_BM, g), dtype=torch.int64)
            for dy in (-1, 0, 1):
                ok = is_out & (y + dy >= 0) & (y + dy < h)
                acc[ok] += q[dy + 1][(r + dy * plan["bw"])[ok]]
            rows = ((n * h + y) * w + xs)[is_out]
            cols = slice(grp * g, (grp + 1) * g)
            out[rows, cols] = (acc[is_out].to(torch.float32)
                               * scale[cols]).to(out_dtype)
            written[rows, cols] += 1
    assert bool((written == 1).all())
    return out.reshape(b, h, w, cout)


def emulate_dma(x, wt, scale, out_dtype):
    """K5's tile walk on the card, in torch: bm flat output pixels a tile,
    each tap's rows loaded as TMA's im2col mode loads them (the pixel at
    the tap's offset, zero outside its image), one product over
    K = 9*Cin per N tile."""
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    plan = tq.dma_plan(b, h, w, cout)
    bn = 256 if plan["bm"] == 128 else 128
    out = torch.zeros((b * h * w, cout), dtype=out_dtype)
    written = torch.zeros(b * h * w, dtype=torch.int64)
    for mt in range(plan["tiles_m"]):
        m, ok = flat_tile(plan, b, h, w, mt)
        mm = torch.where(ok, m, 0)
        n, y, xs = mm // (h * w), (mm // w) % h, mm % w
        taps = []
        for dy, dx in tq._TAPS:
            inb = ok & (y + dy >= 0) & (y + dy < h) & (xs + dx >= 0) \
                & (xs + dx < w)
            a = torch.zeros((plan["bm"], cin), dtype=torch.float64)
            a[inb] = x[n[inb], (y + dy)[inb], (xs + dx)[inb]].to(
                torch.float64)
            taps.append(a)
        a = torch.cat(taps, dim=1)
        for nt in range(cout // bn):
            cols = slice(nt * bn, (nt + 1) * bn)
            acc = (a @ wt[cols].to(torch.float64).T).to(torch.int64)
            out[m[ok], cols] = (acc[ok].to(torch.float32)
                                * scale[cols]).to(out_dtype)
        written[m[ok]] += 1
    assert bool((written == 1).all())
    return out.reshape(b, h, w, cout)


@pytest.mark.parametrize("shape,img_block", [
    ((5, 9, 7, 64, 128), 0),     # two images a box, a ragged last box
    ((3, 8, 4, 64, 256), 0),     # three images in one box
    ((3, 8, 4, 64, 128), 2),     # img_block caps the images a box
    ((2, 20, 16, 64, 128), 0),   # halo boxes, H not a multiple of 6
    ((1, 32, 16, 128, 128), 0),  # block21's geometry
    ((1, 4, 42, 64, 128), 0)])   # the widest row with a halo
def test_ncat_tile_walk_matches_plain(shape, img_block):
    x, wq, scale = inputs(np.random.default_rng(sum(shape)), *shape)
    xt, wt, st = torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale)
    wn = tq.pack_ncat_weight(wt)
    for dt in (torch.float32, torch.bfloat16):
        got = emulate_ncat(xt, wn, st, dt, img_block)
        assert torch.equal(got, tq.conv3x3_s8_plain(xt, wt, st, dt))


@pytest.mark.parametrize("shape", [(5, 9, 7, 64, 128), (5, 5, 7, 64, 256),
                                   (3, 8, 4, 64, 128), (2, 20, 16, 64, 256)])
def test_dma_tile_walk_matches_plain(shape):
    """Flat tiles that cross image rows and images (M = B*H*W is no
    multiple of the tile's rows at any of these shapes)."""
    x, wq, scale = inputs(np.random.default_rng(sum(shape)), *shape)
    xt, wt, st = torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale)
    for dt in (torch.float32, torch.bfloat16):
        got = emulate_dma(xt, wt, st, dt)
        assert torch.equal(got, tq.conv3x3_s8_plain(xt, wt, st, dt))


def bitshift_smem(plan):
    """The shared memory of K4's block for `plan`, laid out as the kernel
    lays it out: two slabs, the B ring, the epilogue's staging, the
    barriers and 1024 bytes of alignment."""
    slab = -(-plan["boxes"] * plan["box_rows"] * plan["bk"] // 1024) * 1024
    return (2 * slab + plan["stages"] * plan["bn"] * plan["bk"]
            + tq._EPI_BYTES + 8 * (2 * plan["stages"] + 4) + 1024)


@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 20, 16), (2048, 32, 16),
                                   (512, 8, 4), (3, 5, 7), (2048, 16, 8),
                                   (1, 4, 42)])
def test_bitshift_plan_covers_every_pixel_once(shape):
    """Every output pixel lies in one flat tile; every tap's row of every
    tile row lies in the slab's loaded rows; the boxes and the ring fit
    the TMA box and the block's shared memory."""
    b, h, w = shape
    for cin, cout in ((64, 128), (128, 256), (256, 512)):
        plan = tq.bitshift_plan(b, h, w, cin, cout)
        bm = plan["bm"]
        assert (bm, plan["bn"]) == ((128, 256) if cout % 256 == 0
                                    else (256, 128))
        assert plan["bk"] == (128 if cin % 128 == 0 else 64)
        hits = torch.zeros(b * h * w, dtype=torch.int64)
        for mt in range(plan["tiles_m"]):
            m = mt * bm + torch.arange(bm)
            hits[m[m < b * h * w]] += 1
        assert bool((hits == 1).all())
        assert plan["slab_rows"] == bm + 2 * (w + 1)
        loaded = plan["boxes"] * plan["box_rows"]
        assert plan["slab_rows"] <= loaded < plan["slab_rows"] + 8 * \
            plan["boxes"]
        rows = [w + 1 + dy * w + dx + i for dy, dx in tq._TAPS
                for i in (0, bm - 1)]
        assert 0 <= min(rows) and max(rows) < plan["slab_rows"]
        assert plan["box_rows"] % 8 == 0 and plan["box_rows"] <= 256
        assert 3 <= plan["stages"] <= 6
        assert bitshift_smem(plan) <= tq.SMEM_MAX
        if plan["stages"] < 6:  # one more stage would not fit
            assert bitshift_smem(dict(plan, stages=plan["stages"] + 1)) > \
                tq.SMEM_MAX


def test_bitshift_plan_at_the_trunk_shapes():
    """block21 (32x16 c128): 256 x 128 tiles, a slab of 290 rows in two
    boxes of 152, six B stages; block31 and the probe's c512 shapes:
    128 x 256 tiles, one box, four stages."""
    p21 = tq.bitshift_plan(2048, 32, 16, 128, 128)
    assert (p21["bm"], p21["bn"], p21["bk"], p21["slab_rows"], p21["boxes"],
            p21["box_rows"], p21["stages"], p21["tiles_m"]) == \
        (256, 128, 128, 290, 2, 152, 6, 4096)
    p31 = tq.bitshift_plan(2048, 16, 8, 256, 256)
    assert (p31["bm"], p31["bn"], p31["slab_rows"], p31["boxes"],
            p31["box_rows"], p31["stages"], p31["tiles_m"]) == \
        (128, 256, 146, 1, 152, 4, 2048)
    p4 = tq.bitshift_plan(512, 8, 4, 512, 512)
    assert (p4["boxes"], p4["box_rows"], p4["tiles_m"]) == (1, 144, 128)


def test_bitshift_plan_rejects_a_row_too_wide():
    # 256 + 2 * 129 rows: more than two boxes of 256
    with pytest.raises(ValueError, match="two TMA boxes"):
        tq.bitshift_plan(1, 2, 128, 128, 128)
    # two slabs of 2 x 192 rows leave room for two B stages of 256 x 128
    with pytest.raises(ValueError, match="fewer than 3"):
        tq.bitshift_plan(1, 2, 120, 128, 256)
    # the widest rows that fit
    assert tq.bitshift_plan(1, 2, 127, 128, 128)["stages"] == 3
    assert tq.bitshift_plan(1, 2, 119, 128, 256)["stages"] == 3


def emulate_bitshift(x, wt, scale, out_dtype):
    """K4's tile walk on the card, in torch: per tile of bm flat output
    pixels, N tile and chunk of bk channels, the slab as the plan's boxes
    load it (flat rows from m0 - (W + 1) on, zero outside [0, M)), and per
    tap the slab rows (W + 1) + dy * W + dx + i, zeroed where the tap
    leaves the image of row i, in one product over the chunk's channels."""
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    plan = tq.bitshift_plan(b, h, w, cin, cout)
    bm, bn, bk = plan["bm"], plan["bn"], plan["bk"]
    m_total, halo = b * h * w, w + 1
    loaded = plan["boxes"] * plan["box_rows"]
    xf = x.reshape(m_total, cin).to(torch.float64)
    out = torch.zeros((m_total, cout), dtype=out_dtype)
    written = torch.zeros(m_total, dtype=torch.int64)
    i = torch.arange(bm)
    for mt in range(plan["tiles_m"]):
        m0 = mt * bm
        rows = m0 - halo + torch.arange(loaded)
        inside = (rows >= 0) & (rows < m_total)
        m = m0 + i
        ok = m < m_total
        mm = torch.where(ok, m, 0)
        y, xs = (mm // w) % h, mm % w
        for nt in range(cout // bn):
            cols = slice(nt * bn, (nt + 1) * bn)
            acc = torch.zeros((bm, bn), dtype=torch.float64)
            for c in range(cin // bk):
                slab = torch.zeros((loaded, bk), dtype=torch.float64)
                slab[inside] = xf[rows[inside], c * bk:(c + 1) * bk]
                for t, (dy, dx) in enumerate(tq._TAPS):
                    keep = ok & (y + dy >= 0) & (y + dy < h) \
                        & (xs + dx >= 0) & (xs + dx < w)
                    a = slab[halo + dy * w + dx + i] * keep[:, None]
                    k0 = t * cin + c * bk
                    acc += a @ wt[cols, k0:k0 + bk].to(torch.float64).T
            out[m[ok], cols] = (acc[ok].to(torch.float32)
                                * scale[cols]).to(out_dtype)
        written[m[ok]] += 1
    assert bool((written == 1).all())
    return out.reshape(b, h, w, cout)


@pytest.mark.parametrize("shape", [
    (5, 9, 7, 64, 128),     # images smaller than a tile, a ragged last one
    (3, 8, 4, 64, 256),     # M = 96: one ragged 128-row tile
    (3, 5, 7, 128, 256),    # 128 x 256 tiles crossing images
    (2, 20, 16, 128, 128),  # 256-row tiles, the last one half used
    (1, 32, 16, 128, 128),  # block21's geometry
    (2, 4, 3, 256, 512),    # two chunks, two N tiles
    (1, 4, 42, 64, 128)])   # a slab of two boxes of 176 rows
def test_bitshift_tile_walk_matches_plain(shape):
    x, wq, scale = inputs(np.random.default_rng(sum(shape)), *shape)
    xt, wt, st = torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale)
    for dt in (torch.float32, torch.bfloat16):
        got = emulate_bitshift(xt, wt, st, dt)
        assert torch.equal(got, tq.conv3x3_s8_plain(xt, wt, st, dt))
