"""DeepLabV3, the segmentation module and the three converters of the port
against the JAX package's, on the CPU.

  * `DeepLabV3` at width 8, head 32, 21 classes, in f32 (eval, random
    running statistics) against flax on the same variables: logits within
    1e-4 relative; the person masks equal except where the top two
    logits lie within 1e-5. The upsampling trap checked alone:
    `jax.image.resize(..., "bilinear")` by 8 against
    `F.interpolate(mode="bilinear", align_corners=False)` within 1e-6.
  * `convert_deeplabv3`, `convert_resnet18_ibn` and `convert_seres18_full`
    against JAX's on the torch mirrors of tests/test_deeplab.py:95 and
    tests/test_torch_convert.py:111, :253: the same state dict in, the
    JAX converter's tree carried through the bridge bit-equal to the port
    converter's model.
  * `SegUNet(base=8)` (train and eval), `gaussian_blur`,
    `extract_foreground_background` and `batched_extraction` at
    tests/test_extras.py:76's size, within 1e-5 of JAX's; two epochs of
    `train_segmenter` at :90's size from one init (the port's, handed to
    JAX's `init`): each epoch's loss within 1e-4 relative.

Every JAX reference takes its variables from the port's init through the
bridge, so JAX compiles no init.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_train_data import two_torch_threads  # noqa: F401

from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables)


def jtree(variables):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, variables)


def random_stats(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif n.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 0.5 + 0.75)
    return model


@pytest.fixture(scope="module")
def deeplab():
    from reid_tpu_torch.models.deeplab import DeepLabV3
    return random_stats(DeepLabV3(21, 8, 32).init_weights(
        torch.Generator().manual_seed(0)).eval())


def test_deeplabv3_matches_flax_f32(deeplab):
    import jax
    import jax.numpy as jnp
    from reid_tpu.models.deeplab import DeepLabV3 as JDeepLab
    from reid_tpu.models.deeplab import extract_foreground as jfg
    from reid_tpu_torch.models.deeplab import extract_foreground

    x = np.random.default_rng(1).normal(size=(2, 64, 48, 3)).astype(
        np.float32)
    fm = JDeepLab(num_classes=21, width=8, head_ch=32)
    want = np.asarray(jax.jit(lambda v, xx: fm.apply(v, xx, train=False))(
        jtree(flax_variables(deeplab)), jnp.asarray(x)))
    with torch.no_grad():
        got = deeplab(torch.from_numpy(x))
    assert got.shape == (2, 64, 48, 21)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
    mask = extract_foreground(got).numpy()
    jmask = np.asarray(jfg(jnp.asarray(want)))
    top2 = np.sort(want, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 1e-5
    assert np.array_equal(mask[~near], jmask[~near])


def test_bilinear_upsampling_matches_jax_resize():
    import jax
    import jax.numpy as jnp
    y = np.random.default_rng(2).normal(size=(2, 8, 6, 5)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(y), (2, 64, 48, 5),
                                       "bilinear"))
    got = F.interpolate(torch.from_numpy(y).permute(0, 3, 1, 2),
                        size=(64, 48), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_convert_deeplabv3_matches_jax():
    from reid_tpu.utils.torch_convert import convert_deeplabv3 as jconvert
    from reid_tpu_torch.models.deeplab import DeepLabV3
    from reid_tpu_torch.utils.torch_convert import convert_deeplabv3
    from test_deeplab import TorchDeepLab, _randomize

    tm = TorchDeepLab(w=8, ch=32, nc=21).eval()
    _randomize(tm)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    def fresh():
        return DeepLabV3(21, 8, 32).init_weights(
            torch.Generator().manual_seed(0))
    via_jax = fresh()
    load_flax_variables(via_jax, jconvert(sd, flax_variables(via_jax)))
    port = fresh()
    assert convert_deeplabv3(sd, port) > 0
    same_state(port, via_jax)
    with pytest.raises(ValueError, match="no tensor"):
        convert_deeplabv3({"backbone.conv1.weight": np.zeros((99, 3, 7, 7))},
                          fresh())


@pytest.mark.parametrize("which", ["resnet18_ibn", "seres18_full"])
def test_seres18_converters_match_jax(which):
    import reid_tpu.utils.torch_convert as jtc
    import reid_tpu_torch.utils.torch_convert as ttc
    from reid_tpu_torch.models import build_model
    from test_torch_convert import (TorchSERes18Full,
                                    _make_torch_ibn_resnet18)

    torch.manual_seed(0)
    tm = (_make_torch_ibn_resnet18() if which == "resnet18_ibn" else
          TorchSERes18Full(num_class=5, num_cams=3, cam_factor=1.5)).eval()
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.8, 1.2)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    base = build_model("seres18", num_classes=5, num_cams=3,
                       dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))

    def fresh():
        return copy.deepcopy(base)
    via_jax = fresh()
    load_flax_variables(via_jax, getattr(jtc, f"convert_{which}")(
        sd, flax_variables(via_jax)))
    port = fresh()
    n = getattr(ttc, f"convert_{which}")(sd, port)
    assert n > 60
    same_state(port, via_jax)
    assert not torch.equal(port.conv0.weight, base.conv0.weight)


@pytest.fixture(scope="module")
def segunet():
    from reid_tpu_torch.data.segmentation import SegUNet
    return random_stats(SegUNet(base=8).init_weights(
        torch.Generator().manual_seed(0)))


def test_segmentation_matches_jax(segunet):
    import jax
    import jax.numpy as jnp
    from reid_tpu.data import segmentation as js
    from reid_tpu_torch.data import segmentation as ts

    x = np.random.default_rng(3).normal(size=(2, 32, 16, 3)).astype(
        np.float32) * 40 + 100
    v = jtree(flax_variables(segunet))
    jm = js.SegUNet(base=8)
    tx = torch.from_numpy(x)

    def close(got, want, tol=1e-5):
        got = got.detach().numpy()
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1)

    masks = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        tmask = segunet(tx, train=False)
        close(tmask, masks)
        train_out, _ = jax.jit(lambda v, xx: jm.apply(
            v, xx, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        close(ts.SegUNet.forward(segunet, tx, train=True), train_out, 1e-4)
    load_flax_variables(segunet, flax_variables(segunet))
    close(ts.gaussian_blur(tx), js.gaussian_blur(jnp.asarray(x)))
    for blur in (True, False):
        close(ts.extract_foreground_background(tx, tmask, blur),
              js.extract_foreground_background(jnp.asarray(x), masks, blur))
        close(ts.batched_extraction(segunet.eval(), tx, blur),
              js.batched_extraction(jm.apply, v, jnp.asarray(x), blur))


def test_train_segmenter_matches_jax(monkeypatch):
    from reid_tpu.data import segmentation as js
    from reid_tpu_torch.data.segmentation import SegUNet, train_segmenter

    rng = np.random.default_rng(0)
    n, h, w = 16, 32, 24
    images = rng.integers(0, 40, (n, h, w, 3)).astype(np.uint8)
    masks = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y, x = 4 + i % 6, 3 + i % 5
        images[i, y:y + 16, x:x + 10] = 220
        masks[i, y:y + 16, x:x + 10] = 1.0
    init = flax_variables(SegUNet(base=8).init_weights(
        torch.Generator().manual_seed(0)))
    monkeypatch.setattr(js.SegUNet, "init",
                        lambda self, *a, **k: jtree(init))
    _, _, want = js.train_segmenter(images, masks, epochs=2, batch_size=8,
                                    base=8, lr=3e-3, log_fn=lambda *_: None)
    model, got = train_segmenter(images, masks, epochs=2, batch_size=8,
                                 base=8, lr=3e-3, log_fn=lambda *_: None,
                                 device="cpu", variables=init)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[1] < got[0]
