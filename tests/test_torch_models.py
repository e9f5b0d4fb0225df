"""SERes18-IBN of the port against the flax model in eval mode, from a
random flax init carried across by the weight bridge: the whole model at
80x40 crops in float32 and in bfloat16 (the default track embed), and one
SEBasicBlock of each flavor at narrow widths in float32 and in bfloat16.

Tolerances:
  * float32: rtol = atol = 1e-4 (another convolution algorithm).
  * bfloat16, one block against the jitted flax block: bit-equal. XLA
    keeps a bf16 conv's product in f32 where a BatchNorm reads it (it
    drops the rounding between the conv and the norm's cast to f32), so
    the port's convs that feed a BatchNorm compute in f32
    (`Conv2d.keep_f32`); IBN reads conv1's product through a channel
    split, which XLA rounds to bf16. Without `keep_f32` 78-85% of a
    block's outputs are bit-equal.
  * bfloat16, the whole model against the jitted flax program: every
    element within 2^-7 of the tensor's largest magnitude (one bf16 ulp
    there) and a cosine >= 0.99999 per row (read: 0.0059 and 0.0033 of
    the largest, 1 - 7e-6). The two still differ by f32 rounding in the
    reductions and GeM's power, which moves a bf16 rounding now and
    then. Without `keep_f32` the features read 0.0088 of the largest and
    a cosine of 1 - 1.7e-5, outside both limits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.models import build_model as jbuild
from reid_tpu.models.seres18 import SEBasicBlock as JBlock
from reid_tpu_torch.models import build_model
from reid_tpu_torch.models.seres18 import SEBasicBlock
from reid_tpu_torch.utils.flax_bridge import (load_flax_variables, load_npz,
                                              save_npz)
from test_torch_train_data import two_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def full_f32():
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _random_stats(tree, rng):
    """Non-trivial BN running statistics, so the bridge's mapping of
    mean/var is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
    return out


def _variables(module, x, seed):
    v = jax.jit(lambda k, xx: module.init(k, xx, train=True))(
        jax.random.PRNGKey(seed), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    return {"params": v["params"],
            "batch_stats": _random_stats(v["batch_stats"],
                                         np.random.default_rng(seed))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seres18_matches_flax(tmp_path, dtype):
    model = jbuild("seres18", num_classes=16, dtype=getattr(jnp, dtype))
    x = np.random.default_rng(0).normal(size=(2, 80, 40, 3)).astype(
        np.float32)
    variables = _variables(model, x, 0)
    fj, lj = jax.jit(lambda v, xx: model.apply(
        v, xx.astype(getattr(jnp, dtype)), train=False))(
            variables, jnp.asarray(x))

    path = str(tmp_path / "seres18.npz")
    save_npz(path, variables)                 # the CLI's --ckpt format
    tm = build_model("seres18", num_classes=16, dtype=getattr(torch, dtype),
                     device="cpu")
    load_flax_variables(tm, load_npz(path))
    with torch.no_grad():
        ft, lt = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert ft.shape == (2, 512) and lt.shape == (2, 16)
    assert ft.dtype == lt.dtype == getattr(torch, dtype)
    for got, want in ((ft, fj), (lt, lj)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            continue
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        assert cos.min() >= 0.99999, cos


@pytest.mark.parametrize("ibn,down,stride,cin,planes",
                         [(False, False, 1, 16, 16), (True, False, 1, 16, 16),
                          (True, True, 2, 8, 16), (False, True, 1, 16, 32)])
def test_se_basic_block_matches_flax(ibn, down, stride, cin, planes):
    block = JBlock(planes=planes, strides=stride, ibn=ibn, downsample=down)
    x = np.random.default_rng(1).normal(size=(3, 8, 6, cin)).astype(
        np.float32)
    variables = _variables(block, x, 2)
    want = block.apply(variables, jnp.asarray(x), train=False)
    tb = SEBasicBlock(cin, planes, stride, ibn, down)
    load_flax_variables(tb, variables)
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ibn,down,stride,cin,planes",
                         [(False, False, 1, 16, 16), (True, False, 1, 16, 16),
                          (True, True, 2, 8, 16), (False, True, 1, 16, 32)])
def test_se_basic_block_bf16_bit_equal_flax(ibn, down, stride, cin, planes):
    block = JBlock(planes=planes, strides=stride, ibn=ibn, downsample=down,
                   dtype=jnp.bfloat16)
    x = np.random.default_rng(1).normal(size=(3, 8, 6, cin)).astype(
        np.float32)
    variables = _variables(block, x, 2)
    want = jax.jit(lambda v, xx: block.apply(v, xx, train=False))(
        variables, jnp.asarray(x).astype(jnp.bfloat16))
    tb = SEBasicBlock(cin, planes, stride, ibn, down, dtype=torch.bfloat16)
    load_flax_variables(tb, variables)
    assert tb.conv1.keep_f32 is not ibn and tb.conv2.keep_f32
    with torch.no_grad():
        got = tb(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_build_model_rejects_unported_backbone():
    # a name that neither registry has
    with pytest.raises(KeyError):
        build_model("video_resnet34", num_classes=4, device="cpu")
