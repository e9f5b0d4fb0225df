"""K3 `conv3x3_s8_ncat`, K4 `conv3x3_s8_bitshift` and K5 `conv3x3_s8_dma`:
the port's plain version of each against the JAX package's kernel of the
same formulation on the same int8 inputs (the Pallas kernel in interpret
mode, one image a grid step, f32 out): equal, since the s32 sums are exact
and the rescale is one f32 multiply. Then, at real widths, all three
against the JAX oracle `conv3x3_s8_reference` in f32 and bf16 (bf16 rounds
the same f32 values to nearest even); the image-block invariance of the K3
and K5 plain versions; the ncat weight packing; the probe's CPU run; and
that a CPU tensor launches nothing. The CUDA kernels against their plain
versions are in test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.ops import qconv as jq
from reid_tpu_torch import qconv_probe
from reid_tpu_torch.ops import launch_counts, reset_launch_counts
from reid_tpu_torch.ops import qconv as tq

from test_torch_qconv import inputs, pack_hwio

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
