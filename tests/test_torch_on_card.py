"""The port's CUDA kernels against their plain versions, on a card.

Every test here takes the `cuda` fixture and skips where there is no card.
The file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py

Tolerances:
  * conv3x3_s8: exact. The s32 accumulator is exact on both sides and the
    rescale is one f32 multiply.
  * se_basic_block_s8: rtol = atol = 1e-4 on >= 99.9% of the elements and
    5e-2 on all, the plain version's tolerance against the JAX reference.
    The plain version sums the per-image means and the SE dot products in
    the kernel's fixed order, so the two agree bit for bit at the shapes
    measured so far; summed in torch's order instead, a mean can differ by
    an ulp and move a requantization tie by one step.
  * the int8 embed, card against CPU: cosine >= 0.999 per row.
"""

import numpy as np
import pytest
import torch

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
                                   (2, 9, 11, 64, 128)])
def test_conv3x3_s8_matches_plain(cuda, shape):
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


FLAVORS = {"identity": (128, 128, False, False),
           "down": (256, 512, True, False),
           "ibn": (128, 128, False, True),
           "ibn256": (256, 256, False, True)}


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_se_basic_block_s8_matches_plain(cuda, flavor):
    cin, cout, down, ibn = FLAVORS[flavor]
    rng = np.random.default_rng(7)
    p = block_params(rng, cin, cout, down, ibn, cuda)
    x = torch.from_numpy(rng.normal(size=(5, 9, 7, cin)).astype(
        np.float32)).to(torch.bfloat16).to(cuda)
    reset_launch_counts()
    got = tqb.se_basic_block_s8(x, p, ibn=ibn)
    assert launch_counts()[tqb.NAME] == 1
    want = tqb.se_basic_block_s8_plain(x, p, ibn=ibn)
    torch.cuda.synchronize()
    within(got.float().cpu().numpy(), want.float().cpu().numpy())


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
