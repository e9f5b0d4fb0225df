"""One int8 serving artifact (`torch.export`, K1 as the custom op
`reid_tpu_torch::conv3x3_s8` at each of its 10 sites, no fused block) of
CARes18 and of EMARes18 at 64x32 with a dynamic batch, loaded in process:
bit-equal to serving the same model in process at two batch sizes, as
tests/test_torch_baseline.py holds the baseline's. The weights are
test_torch_cares.py's."""

import pytest
import torch

from reid_tpu_torch.models import build_model
from reid_tpu_torch.utils.flax_bridge import load_flax_variables
from test_torch_cares import C, K1_SITES, NAMES, variables  # noqa: F401
from test_torch_train_data import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", NAMES)
def test_int8_artifact_serves_as_in_process(variables, name, tmp_path):
    """As test_torch_baseline.py holds the baseline's artifact; one
    calibration serves both."""
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             export_reid_artifact,
                                             load_serving_fn,
                                             make_int8_embed_fn)

    model = build_model(name, num_classes=C, device="cpu")
    load_flax_variables(model, variables[name])
    gen = torch.Generator().manual_seed(0)
    calib = torch.rand((4, 64, 32, 3), generator=gen) * 255
    path = str(tmp_path / f"{name}.pt2")
    qstate = calibrate_serving_qstate(model, calib)
    ep = export_reid_artifact(model, path, 64, 32, qstate=qstate)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert sum("conv3x3_s8" in t for t in targets) == len(K1_SITES)
    assert not any("se_basic_block_s8" in t for t in targets)
    serve = make_int8_embed_fn(model, qstate=qstate)
    fn = load_serving_fn(path)
    for b in (1, 3):
        x = torch.rand((b, 64, 32, 3), generator=gen) * 255
        with torch.no_grad():
            want = serve(x)
            got = fn(x)
        assert got.shape == (b, 512 + C)
        assert torch.equal(got, want)
