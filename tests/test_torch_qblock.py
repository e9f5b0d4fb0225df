"""K2 `se_basic_block_s8`: the port's plain version against the JAX
package's oracle `qblock_reference`, for the three block flavors, with
random parameters (as tests/test_qblock.py makes them) and with the folded
parameters of a real quantized block. The CUDA kernel against the plain
version is in test_torch_on_card.py.

Tolerance: rtol = atol = 1e-4 on at least 99.9% of the elements and 5e-2
on all of them. The integer convolutions are exact on both sides, but the
per-image means (IN statistics, SE pooling) are summed in another order
(the port sums as its CUDA kernel does, the reference as XLA:CPU does),
which can move a requantization tie by one step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.ops import qblock as jqb
from reid_tpu_torch.ops import qblock as tqb
from test_torch_train_data import two_torch_threads  # noqa: F401


def within(got, want, tight=1e-4, loose=5e-2, share=0.999):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    ok = err <= tight + tight * np.abs(want)
    assert ok.mean() >= share, (ok.mean(), err.max())
    assert np.all(err <= loose + loose * np.abs(want)), err.max()


def jax_params(rng, cin, cout, down=False, ibn=False, mip=8):
    def i8(*shape):
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)

    def f32(*shape, lo=-1.0, hi=1.0):
        return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)

    half = cout // 2
    kw = {}
    if down:
        kw = dict(wd=i8(cin, cout), ad=f32(cout, lo=0.01, hi=0.1),
                  cd=f32(cout), inv_sxd=jnp.float32(rng.uniform(5, 20)))
    if ibn:
        pad = np.zeros(cout, np.float32)
        kw.update(
            dq1_vec=f32(cout, lo=0.001, hi=0.01),
            in_scale=jnp.asarray(np.concatenate(
                [rng.uniform(0.5, 1.5, half), pad[half:]]), jnp.float32),
            in_bias=jnp.asarray(np.concatenate(
                [rng.uniform(-0.5, 0.5, half), pad[half:]]), jnp.float32),
            a1=jnp.asarray(np.concatenate(
                [pad[:half], rng.uniform(0.1, 1.0, half)]), jnp.float32),
            c1=jnp.asarray(np.concatenate(
                [pad[:half], rng.uniform(-0.5, 0.5, half)]), jnp.float32))
    else:
        kw.update(a1=f32(cout, lo=0.001, hi=0.01), c1=f32(cout))
    return jqb.QBlockParams(
        w1=i8(9, cin, cout), w2=i8(9, cout, cout),
        a2=f32(cout, lo=0.001, hi=0.01), c2=f32(cout),
        inv_sx1=jnp.float32(rng.uniform(5, 20)),
        inv_sx2=jnp.float32(rng.uniform(5, 20)),
        wfc1=f32(cout, mip).astype(jnp.bfloat16),
        wfc2=f32(mip, cout).astype(jnp.bfloat16), **kw)


def to_port(p) -> tqb.QBlockParams:
    """JAX QBlockParams -> the port's (packed conv weights, float scalars)."""
    def t(v):
        return None if v is None else torch.from_numpy(np.array(
            v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)).to(
                torch.bfloat16 if v.dtype == jnp.bfloat16 else None)

    def pack(w9):
        w9 = np.asarray(w9)
        return torch.from_numpy(np.ascontiguousarray(
            w9.transpose(2, 0, 1).reshape(w9.shape[2], -1)))

    def s(v):
        return None if v is None else float(np.float32(v))

    return tqb.QBlockParams(
        w1=pack(p.w1), w2=pack(p.w2), a1=t(p.a1), c1=t(p.c1), a2=t(p.a2),
        c2=t(p.c2), inv_sx1=s(p.inv_sx1), inv_sx2=s(p.inv_sx2),
        wfc1=t(p.wfc1), wfc2=t(p.wfc2),
        wd=None if p.wd is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(p.wd).T)),
        ad=t(p.ad), cd=t(p.cd), inv_sxd=s(p.inv_sxd), dq1_vec=t(p.dq1_vec),
        in_scale=t(p.in_scale), in_bias=t(p.in_bias))


FLAVORS = {"identity": (8, 8, False, False), "down": (16, 8, True, False),
           "ibn": (8, 8, False, True)}


# An IBN block whose images span the kernel's output tiles: at Cout = 8 a
# tile holds 256 rows, 16 of a 32x16 image's 32 rows, so the plain version
# sums the per-image means in its cross-tile order (`tile_segments`).
SPANNING = {"ibn_spanning": (8, 8, False, True)}


@pytest.mark.parametrize("flavor", list(FLAVORS) + list(SPANNING))
def test_plain_matches_jax_reference_random_params(flavor):
    cin, cout, down, ibn = {**FLAVORS, **SPANNING}[flavor]
    rng = np.random.default_rng({"identity": 1, "down": 2, "ibn": 3,
                                 "ibn_spanning": 10}[flavor])
    p = jax_params(rng, cin, cout, down=down, ibn=ibn)
    shape = (2, 32, 16) if flavor in SPANNING else (3, 6, 4)
    if flavor in SPANNING:
        assert len(tqb.tile_segments(32, 16, cout)) == 2
    x = jnp.asarray(rng.normal(size=(*shape, cin)), jnp.bfloat16)
    want = jqb.qblock_reference(x, p, ibn=ibn)
    got = tqb.se_basic_block_s8(
        torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16), to_port(p), ibn=ibn, out_dtype=torch.float32)
    within(got.numpy(), want)


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_plain_in_torch_order_matches_jax_reference(flavor):
    """The plain version with its reductions summed as torch sums them
    (`kernel_order=False`, the yardstick chip_smoke.py also reads) holds
    the same tolerance against the reference."""
    cin, cout, down, ibn = FLAVORS[flavor]
    rng = np.random.default_rng({"identity": 4, "down": 5, "ibn": 6}[flavor])
    p = jax_params(rng, cin, cout, down=down, ibn=ibn)
    x = jnp.asarray(rng.normal(size=(3, 6, 4, cin)), jnp.bfloat16)
    want = jqb.qblock_reference(x, p, ibn=ibn)
    got = tqb.se_basic_block_s8_plain(
        torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16), to_port(p), ibn=ibn, out_dtype=torch.float32,
        kernel_order=False)
    within(got.numpy(), want)


@pytest.mark.parametrize("ibn,down,cin,planes", [(False, False, 16, 16),
                                                 (True, False, 16, 16),
                                                 (False, True, 8, 16)])
def test_plain_matches_jax_with_params_of_a_real_block(ibn, down, cin,
                                                       planes):
    """`make_qblock_params` of a flax block quantized by the JAX package,
    carried across, equals the JAX folded parameters exactly, and the
    plain block agrees with `qblock_reference` on them."""
    from reid_tpu.models.seres18 import SEBasicBlock as JBlock
    from reid_tpu.utils.quantize import make_qblock_params as jmake
    from reid_tpu.utils.quantize import quantize as jquantize
    from reid_tpu_torch.models.seres18 import SEBasicBlock
    from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                                  quant_state_from_flax)
    from reid_tpu_torch.utils.quantize import make_qblock_params

    rng = np.random.default_rng(13 + cin + ibn)
    block = JBlock(planes=planes, strides=1, ibn=ibn, downsample=down,
                   dtype=jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(2, 5, 4, cin)), jnp.bfloat16)
    variables = block.init(jax.random.PRNGKey(1), x, train=True)
    qs = jquantize(block, variables, [x], train=False)
    jp = jmake(variables, qs, prefix="", planes=planes, ibn=ibn,
               downsample=down)

    tb = SEBasicBlock(cin, planes, 1, ibn, down, dtype=torch.bfloat16)
    load_flax_variables(tb, jax.tree_util.tree_map(np.asarray, variables))
    tp = make_qblock_params(tb, quant_state_from_flax(qs, "cpu"), "")
    want_p = to_port(jp)
    for name, a, b in zip(tp._fields, tp, want_p):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name

    want = jqb.qblock_reference(x, jp, ibn=ibn)
    got = tqb.se_basic_block_s8(
        torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16), tp, ibn=ibn, out_dtype=torch.float32)
    within(got.numpy(), want)
