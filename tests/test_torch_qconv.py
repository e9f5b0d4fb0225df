"""K1 `conv3x3_s8`: the port's plain version against the JAX package's
oracle `conv3x3_s8_reference` on the same int8 inputs (f32 output
identical: the accumulator is exact and the rescale is one f32 multiply),
the routing predicate, and that a CPU tensor launches nothing. The CUDA
kernel against the plain version is in test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.ops import qconv as jq
from reid_tpu_torch.ops import launch_counts, reset_launch_counts
from reid_tpu_torch.ops import qconv as tq


def pack_hwio(w):
    """JAX HWIO (3,3,Cin,Cout) -> the port's packed (Cout, 9*Cin)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w).reshape(9, w.shape[2], w.shape[3]).transpose(2, 0, 1)
        .reshape(w.shape[3], -1)))


def inputs(rng, b, h, w, cin, cout):
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    return x, wq, scale


@pytest.mark.parametrize("shape", [(2, 5, 4, 16, 8), (1, 3, 7, 8, 24),
                                   (3, 4, 2, 128, 128)])
def test_plain_matches_jax_reference(shape):
    b, h, w, cin, cout = shape
    x, wq, scale = inputs(np.random.default_rng(sum(shape)), *shape)
    want = jq.conv3x3_s8_reference(jnp.asarray(x), jnp.asarray(wq),
                                   jnp.asarray(scale), out_dtype=jnp.float32)
    got = tq.conv3x3_s8(torch.from_numpy(x), pack_hwio(wq),
                        torch.from_numpy(scale), out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bf16 output rounds the same f32 values to nearest even
    want16 = jq.conv3x3_s8_reference(jnp.asarray(x), jnp.asarray(wq),
                                     jnp.asarray(scale))
    got16 = tq.conv3x3_s8(torch.from_numpy(x), pack_hwio(wq),
                          torch.from_numpy(scale))
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(want16, np.float32))


def test_pack_roundtrip():
    w = torch.randint(-127, 128, (24, 16, 3, 3), dtype=torch.int8)
    assert torch.equal(tq.unpack_conv_weight(tq.pack_conv_weight(w), 3, 3),
                       w)


def test_applicable_matches_jax():
    for cin, cout, stride, pad in [(128, 128, 1, 1), (256, 256, 1, 1),
                                   (64, 128, 1, 1), (128, 128, 2, 1),
                                   (128, 256, 1, 0), (256, 512, 1, 1)]:
        want = jq.qconv_applicable((2, 8, 8, cin), (3, 3, cin, cout),
                                   (stride, stride), [(pad, pad)] * 2, 1,
                                   (1, 1), (1, 1))
        got = tq.qconv_applicable((2, 8, 8, cin), (cout, cin, 3, 3),
                                  (stride, stride), (pad, pad))
        assert got == want, (cin, cout, stride, pad)


def test_cpu_tensor_takes_plain_version_without_launch():
    reset_launch_counts()
    x, wq, scale = inputs(np.random.default_rng(0), 1, 4, 4, 128, 128)
    tq.conv3x3_s8(torch.from_numpy(x), pack_hwio(wq), torch.from_numpy(scale))
    assert launch_counts().get(tq.NAME, 0) == 0
