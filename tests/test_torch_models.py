"""SERes18-IBN of the port against the flax model, in float32 eval mode,
from a random flax init carried across by the weight bridge: the whole
model at 80x40 crops and one SEBasicBlock of each flavor at narrow widths.
Tolerance: rtol = atol = 1e-4 (f32, another convolution algorithm)."""

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


def test_seres18_matches_flax(tmp_path):
    model = jbuild("seres18", num_classes=16)
    x = np.random.default_rng(0).normal(size=(2, 80, 40, 3)).astype(
        np.float32)
    variables = _variables(model, x, 0)
    fj, lj = model.apply(variables, jnp.asarray(x), train=False)

    path = str(tmp_path / "seres18.npz")
    save_npz(path, variables)                 # the CLI's --ckpt format
    tm = build_model("seres18", num_classes=16, device="cpu")
    load_flax_variables(tm, load_npz(path))
    with torch.no_grad():
        ft, lt = tm(torch.from_numpy(x))
    assert ft.shape == (2, 512) and lt.shape == (2, 16)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


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


def test_build_model_rejects_unported_backbone():
    with pytest.raises(KeyError):
        build_model("osnet_x1_0", num_classes=4, device="cpu")
