"""One train step of CARes18, EMARes18 and SERes18 with BatchRenorm
(`renorm=True`) in the port against the JAX package's `make_train_step`,
at 64x32 (the biased-variance trap, test_torch_train_step.py), f32, 4
classes, a batch of 8 (4 ids x 2), from one carried state
(`train_state_from_flax`) whose weights are the port's random init with
random running statistics and conv biases (test_torch_cares.py). Every
loss component within 1e-4 relative, the parameter update at a cosine
>= 0.9995 and within 3% of its norm (Adam's sign noise), the statistics
within 1e-3 of their largest magnitude and every `steps` counter equal.
The renorm SERes18's counters stand past warm-up (750) with running
variances far below the batch's, so that r clips (checked on the port's
norms).

The renorm step stands for `train_main --renorm`, whose flag the JAX
package's own `train_cnn` drops (ROADMAP C): it is held against JAX's
`build_model("seres18", renorm=True)` directly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reid_tpu.config as jcfg
import reid_tpu_torch.config as tcfg
from reid_tpu.models import build_model as jbuild
from reid_tpu.train.steps import make_train_step as jmake_train_step
from reid_tpu_torch.models.layers import BatchRenorm
from reid_tpu_torch.train.steps import make_train_step
from reid_tpu_torch.utils.flax_bridge import (load_flax_variables,
                                              torch_state_dict,
                                              train_state_from_flax)
from test_torch_cares import port_variables
from test_torch_train_data import (jax_augment_draws,  # noqa: F401
                                   two_torch_threads)
from test_torch_train_step import B, H, LABELS, W, close, images
from test_torch_train_step import jax_state as seres_jax_state

TC = 4


def past_warmup(v):
    """Every `steps` counter at 750 and every running variance divided by
    25 (r = std / ra_std then passes r_max = 2 wherever the batch's
    variance is near the old running one)."""
    def walk(node):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x)
        if "steps" in node:
            node["steps"] = np.int32(750)
            node["var"] = (node["var"] / 25.0).astype(np.float32)
    walk(v["batch_stats"])
    return v


def r_clips(model, x):
    """Whether some BatchRenorm of `model` clips r in a train-mode forward
    of `x` (read from each norm's input)."""
    seen = []

    def hook(m, args):
        xf = args[0].detach().to(torch.float32)
        dims = tuple(range(xf.ndim - 1))
        std = torch.sqrt(xf.var(dims, unbiased=False) + m.eps)
        r = std / torch.sqrt(m.running_var + m.eps)
        r_max = float(m._limits()[0])
        seen.append(bool(((r > r_max) | (r < 1 / r_max)).any()))
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchRenorm)]
    with torch.no_grad():
        model(x, train=True)
    for h in hooks:
        h.remove()
    return len(seen) == 20 and any(seen)


@pytest.mark.parametrize("name,renorm", [("cares18", False),
                                         ("emares18", False),
                                         ("seres18", True)])
def test_train_step_matches_jax(name, renorm):
    train = dict(batch_size=B, num_instances=2, lr=1e-4, warmup_epochs=1,
                 hold_epochs=2, epochs=3)
    data = dict(height=H, width=W, pad=4)
    jc = jcfg.Config(
        model=dataclasses.replace(jcfg.ModelConfig(), backbone=name,
                                  num_classes=TC, dtype="float32",
                                  renorm=renorm),
        train=dataclasses.replace(jcfg.TrainConfig(), **train),
        data=dataclasses.replace(jcfg.DataConfig(), **data))
    tc = tcfg.Config(model=tcfg.ModelConfig(backbone=name, num_classes=TC,
                                            dtype="float32", renorm=renorm),
                     train=tcfg.TrainConfig(**train),
                     data=tcfg.DataConfig(**data))
    v = port_variables(name, TC, renorm, seed=2)
    if renorm:
        v = past_warmup(v)
    js = seres_jax_state(v, jc, num_classes=TC)
    kw = dict(renorm=True) if renorm else {}
    js = js.replace(apply_fn=jbuild(name, num_classes=TC, **kw).apply,
                    xbm=None)
    ts = train_state_from_flax(js, tc, 1, device="cpu")
    if renorm:
        assert r_clips(ts.model, torch.from_numpy(images(11)))
        load_flax_variables(ts.model, v)
    start = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    x = images(10, uint8=True)
    key = jax.random.PRNGKey(20)
    js, jm = jmake_train_step(jc)(js, {"images": jnp.asarray(x),
                                       "aug_key": key,
                                       "labels": jnp.asarray(LABELS)})
    ts, tm = make_train_step(tc)(ts, {
        "images": torch.from_numpy(x),
        "aug_draws": jax_augment_draws(key, B, H, W, 4),
        "labels": torch.from_numpy(LABELS)})
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    sd = torch_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, js.params), "batch_stats": jax.tree_util.tree_map(
            np.asarray, js.batch_stats)})
    names = [n for n, _ in ts.model.named_parameters()]
    upd_t = torch.cat([(p.detach() - start[n]).ravel()
                       for n, p in ts.model.named_parameters()]).double()
    upd_j = torch.cat([(sd[n] - start[n]).ravel() for n in names]).double()
    assert float(upd_t @ upd_j / (upd_t.norm() * upd_j.norm())) >= 0.9995
    assert float((upd_t - upd_j).norm()) <= 0.03 * float(upd_j.norm())
    n_steps = 0
    for bname, b in ts.model.named_buffers():
        if bname.endswith("steps"):
            assert int(b) == int(sd[bname]) == 751
            n_steps += 1
        else:
            close(b.numpy(), sd[bname].numpy(), 1e-3)
    assert n_steps == (20 if renorm else 0)


# int8

