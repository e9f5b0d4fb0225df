"""Serving artifacts: the port's `torch.export` round trip (a `.pt2` with a
symbolic batch axis, where the JAX package writes StableHLO), and
`export_reid_artifact` of a small SERes18 at 80x40 in f32 and int8.

A loaded artifact must give the bits that serving the same model in
process gives, on the CPU, at every batch size; the int8 graph must hold
both kernels as custom ops (`reid_tpu_torch::conv3x3_s8`,
`reid_tpu_torch::se_basic_block_s8`), so that on the card it launches
them."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.utils.export import export_serving_fn as jexport
from reid_tpu.utils.export import load_serving_fn as jload
from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                         export_reid_artifact,
                                         load_serving_fn, make_embed_fn)
from reid_tpu_torch.models import build_model
from reid_tpu_torch.ops import qblock, qconv
from reid_tpu_torch.utils.export import export_serving_fn
from reid_tpu_torch.utils.quantize import quantized_model
from test_torch_train_data import two_torch_threads  # noqa: F401


def test_export_roundtrip_dynamic_batch(tmp_path):
    """tests/test_utils.py's round trip, in both packages: the port's
    artifact gives its direct call's bits at B = 1, 3 and 16, and JAX's
    artifact's values within 1e-5."""
    w = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    wt = torch.from_numpy(w)

    def serving(x):
        return torch.tanh(x @ wt)

    export_serving_fn(serving, (torch.zeros((2, 8)),),
                      str(tmp_path / "model.pt2"))
    loaded = load_serving_fn(str(tmp_path / "model.pt2"))
    jp = str(tmp_path / "model.stablehlo")
    jexport(lambda x: jnp.tanh(x @ jnp.asarray(w)), (jnp.zeros((2, 8)),), jp)
    jloaded = jload(jp)
    for b in (1, 3, 16):
        x = np.random.default_rng(b).normal(size=(b, 8)).astype(np.float32)
        got = loaded(torch.from_numpy(x))
        assert torch.equal(got, serving(torch.from_numpy(x)))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jloaded(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def seres18():
    torch.manual_seed(0)
    model = build_model("seres18", num_classes=6, num_cams=6,
                        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (5, 80, 40, 3)).astype(
        np.float32))
    return model, images


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_reid_artifact_matches_direct_serving(seres18, tmp_path, int8):
    model, images = seres18
    qs = calibrate_serving_qstate(model, images[:4]) if int8 else None
    path = str(tmp_path / "reid.pt2")
    ep = export_reid_artifact(model, path, 80, 40, qstate=qs)
    graph = str(ep.graph)
    n_k1 = graph.count("reid_tpu_torch.conv3x3_s8")
    n_k2 = graph.count("reid_tpu_torch.se_basic_block_s8")
    # SERes18's routed int8 layers: two 3x3 convs on K1, four blocks on K2
    assert (n_k1, n_k2) == ((2, 4) if int8 else (0, 0))
    served = make_embed_fn(quantized_model(model, qs) if int8 else model)
    loaded = load_serving_fn(path)
    with torch.inference_mode():
        for b in (1, 3, 5):
            want = served(images[:b])
            got = loaded(images[:b])
            assert got.shape == (b, 512 + 6)
            assert torch.equal(got, want), b
    # a process that has imported nothing else of the port loads it too
    # (load_serving_fn registers the custom ops the int8 graph calls)
    np.save(tmp_path / "x.npy", images.numpy())
    code = ("import sys, numpy as np, torch\n"
            "from reid_tpu_torch.utils.export import load_serving_fn\n"
            "f = load_serving_fn(sys.argv[1])\n"
            "x = torch.from_numpy(np.load(sys.argv[2]))\n"
            "np.save(sys.argv[3], f(x).numpy())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code, path, str(tmp_path / "x.npy"),
                    str(tmp_path / "y.npy")], check=True, timeout=300,
                   env={**os.environ, "PYTHONPATH": os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")])})
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want.numpy())


def test_kernel_ops_have_fake_implementations():
    """Each custom op's fake gives the output shape and dtype that the
    plain version computes, so that export can trace it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-5, 6, (2, 4, 4, 64)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-3, 4, (128, 9 * 64)).astype(np.int8))
    scale = torch.full((128,), 1e-2)
    want = qconv.conv3x3_s8(x, wt, scale, torch.float32)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = qconv.conv3x3_s8(x, wt, scale, torch.float32)
    assert fake.shape == want.shape and fake.dtype == want.dtype
    p = qblock.QBlockParams(
        w1=wt, w2=torch.zeros((128, 9 * 128), dtype=torch.int8),
        a1=scale, c1=scale, a2=scale, c2=scale, inv_sx1=4.0, inv_sx2=4.0,
        wfc1=torch.zeros((128, 8), dtype=torch.bfloat16),
        wfc2=torch.zeros((8, 128), dtype=torch.bfloat16),
        wd=torch.zeros((128, 64), dtype=torch.int8), ad=scale, cd=scale,
        inv_sxd=4.0)
    xb = torch.from_numpy(rng.normal(size=(2, 4, 4, 64)).astype(
        np.float32)).to(torch.bfloat16)
    want = qblock.se_basic_block_s8(xb, p)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = qblock.se_basic_block_s8(xb, p)
    assert fake.shape == want.shape == (2, 4, 4, 128)
    assert fake.dtype == want.dtype == torch.bfloat16
