"""The training slice's data layer against the JAX package's: the PK
sampler and the train loader bit-equal under the same seeds; the
augmentation's and the crop-jitter transform's apply steps bit-equal to
`augment_batch` / `strong_inference_batch` when handed the draws that
JAX's keys give; the port's own draws inside the ranges JAX draws from;
and the continual phase's dataset bookkeeping."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reid_tpu.data import transforms as jt
from reid_tpu.data.dataset import synthetic_dataset as jsynthetic
from reid_tpu.data.loader import make_train_loader as jmake_train_loader
from reid_tpu.data.sampler import pk_epoch_indices as jpk
from reid_tpu_torch.data import transforms as tt
from reid_tpu_torch.data.dataset import synthetic_dataset
from reid_tpu_torch.data.loader import make_train_loader
from reid_tpu_torch.data.sampler import pk_epoch_indices


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for the training slice's tests, whose tensors
    are small: no slower alone, and six test workers then do not
    oversubscribe the host's cores. The caller's count comes back."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def place_seeded_luts(monkeypatch):
    """JAX's `train_cnn` seeds the DCC tables (`seed_dcc_luts`) after it
    has placed the state on its mesh, so its first step takes the tables
    unplaced and its second, taking the first step's placed outputs,
    traces and compiles the whole step again. Here the seeded tables get
    the placement of the state's parameters: the same values, and one
    compile of the step."""
    import reid_tpu.train.image_train as jimage_train
    seed = jimage_train.seed_dcc_luts

    def placed(state, *a, **kw):
        out = seed(state, *a, **kw)
        sharding = jax.tree_util.tree_leaves(state.params)[0].sharding
        dcc = jax.device_put(out.loss_state.dcc, sharding)
        return out.replace(loss_state=out.loss_state._replace(dcc=dcc))
    monkeypatch.setattr(jimage_train, "seed_dcc_luts", placed)


def jax_augment_draws(key, b, h, w, pad):
    """The random numbers `augment_batch(key, ...)` draws, split from the
    key exactly as it splits them, in `augment_apply`'s form."""
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    return {k: t(v) if k.endswith("_u") else t(v).long()
            for k, v in _jax_draws(key, b, h, w, pad).items()}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draws(key, b, h, w, pad, sl=0.02, sh=0.4, r1=0.3):
    kflip, kcy, kcx, key = jax.random.split(key, 4)

    def per_sample(k):
        kg, kgr, ke, ker = jax.random.split(k, 4)
        return (jax.random.uniform(kg),
                jnp.stack(jt._sample_rect(kgr, h, w, sl, sh, r1)),
                jax.random.uniform(ker),
                jnp.stack(jt._sample_rect(ke, h, w, sl, sh, r1)))
    gray_u, gray_rect, erase_u, erase_rect = jax.vmap(per_sample)(
        jax.random.split(key, b))
    return {"flip_u": jax.random.uniform(kflip, (b,)),
            "oy": jax.random.randint(kcy, (b,), 0, 2 * pad + 1),
            "ox": jax.random.randint(kcx, (b,), 0, 2 * pad + 1),
            "gray_u": gray_u, "gray_rect": gray_rect,
            "erase_u": erase_u, "erase_rect": erase_rect}


@pytest.mark.parametrize("labels,bs,k", [
    (np.repeat(np.arange(10), 6), 16, 4),
    (np.concatenate([np.repeat(np.arange(6), 5), [6, 7, 7]]), 8, 2),
    (np.random.default_rng(0).integers(0, 9, 70), 12, 3)])
def test_pk_sampler_bit_equal(labels, bs, k):
    for seed in range(3):
        got = pk_epoch_indices(labels, bs, k, np.random.default_rng(seed))
        want = jpk(labels, bs, k, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        # P distinct ids with K instances each, whole batches
        assert len(got) % bs == 0
        for s in range(0, len(got), bs):
            counts = np.bincount(labels[got[s:s + bs]])
            assert set(counts[counts > 0]) == {k}


@pytest.mark.parametrize("k", [2, 0])
def test_train_loader_bit_equal(k):
    """PK (K = 2) and the plain shuffle (K = 0): the same batches, images
    included, epoch by epoch; the last batch wraps as the JAX loader's
    does."""
    mine = synthetic_dataset(n=30, num_pids=5, seed=1)
    ref = jsynthetic(n=30, num_pids=5, seed=1)
    for epoch in (0, 1):
        got = list(make_train_loader(mine, 8, k, seed=3, epoch=epoch,
                                     device="cpu"))
        want = list(jmake_train_loader(ref, 8, k, seed=3, epoch=epoch,
                                       device_put=False))
        assert len(got) == len(want) > 2
        for g, w in zip(got, want):
            for key in ("images", "labels", "cams", "seqs", "weights"):
                np.testing.assert_array_equal(g[key].numpy(), w[key])


@pytest.mark.parametrize("pad,flip,erase,lg,gg", [
    (10, 0.5, 0.5, 0.35, 0.05), (0, 0.0, 0.0, 0.35, 0.05),
    (4, 1.0, 1.0, 0.6, 0.3)])
def test_augment_apply_equals_jax_under_its_draws(pad, flip, erase, lg, gg):
    rng = np.random.default_rng(pad)
    images = rng.integers(0, 256, (8, 32, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(pad + 1)
    want = jt.augment_batch(key, jnp.asarray(images), pad=pad,
                            flip_prob=flip, erase_prob=erase, lg_prob=lg,
                            gg_prob=gg)
    draws = jax_augment_draws(key, 8, 32, 16, pad)
    got = tt.augment_apply(torch.from_numpy(images), draws, pad=pad,
                           flip_prob=flip, erase_prob=erase, lg_prob=lg,
                           gg_prob=gg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("flipped", [False, True])
def test_strong_inference_apply_equals_jax(flipped):
    images = np.random.default_rng(5).integers(0, 256, (6, 32, 16, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = jt.strong_inference_batch(key, jnp.asarray(images),
                                     flipped=flipped)
    k1, k2 = jax.random.split(key)
    draws = {"oy": torch.from_numpy(np.array(
                 jax.random.randint(k1, (6,), 0, 21))),
             "ox": torch.from_numpy(np.array(
                 jax.random.randint(k2, (6,), 0, 21)))}
    got = tt.strong_inference_apply(torch.from_numpy(images), draws,
                                    flipped=flipped)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draws_cover_jax_ranges():
    """The port's own draws lie where JAX's do: uniforms in [0, 1),
    offsets in [0, 2 pad], rectangles inside the image with sides in
    [1, h - 1] x [1, w - 1]; and the draw is the generator's, so a
    reseeded generator repeats it."""
    h, w, pad, b = 256, 128, 10, 2048
    d = tt.augment_draws(torch.Generator().manual_seed(0), b, h, w,
                         pad=pad, device="cpu")
    again = tt.augment_draws(torch.Generator().manual_seed(0), b, h, w,
                             pad=pad, device="cpu")
    jd = jax_augment_draws(jax.random.PRNGKey(0), b, h, w, pad)
    for key, v in d.items():
        assert torch.equal(v, again[key])
        assert v.shape == jd[key].shape and v.dtype == jd[key].dtype
    for key in ("flip_u", "gray_u", "erase_u"):
        assert 0.0 <= float(d[key].min()) and float(d[key].max()) < 1.0
    for key in ("oy", "ox"):
        assert int(d[key].min()) == 0 and int(d[key].max()) == 2 * pad
    for key in ("gray_rect", "erase_rect"):
        for r in (d[key], jd[key]):
            y0, x0, rh, rw = r.T
            assert int(rh.min()) >= 1 and int(rh.max()) <= h - 1
            assert int(rw.min()) >= 1 and int(rw.max()) <= w - 1
            assert bool((y0 >= 0).all() and (x0 >= 0).all())
            assert bool((y0 + rh <= h).all() and (x0 + rw <= w).all())
        # the area and aspect draws span the same ranges
        area = (d[key][:, 2] * d[key][:, 3]).double() / (h * w)
        jarea = (jd[key][:, 2] * jd[key][:, 3]).double() / (h * w)
        assert abs(float(area.mean()) - float(jarea.mean())) < 0.02
    s = tt.strong_inference_draws(torch.Generator().manual_seed(1), b,
                                  device="cpu")
    assert int(s["oy"].min()) == 0 and int(s["ox"].max()) == 20


def test_continual_dataset_bookkeeping():
    """add_pseudo, set_cross_domain, the per-sample flags as weights and
    the class stats, as the JAX package's dataset keeps them."""
    mine = synthetic_dataset(n=12, num_pids=3)
    ref = jsynthetic(n=12, num_pids=3)
    pseudo = [("<p0>", 3, 0, 0), ("<p1>", 4, 1, 0), ("<p2>", 3, 1, 0)]
    for ds in (mine, ref):
        ds.add_pseudo(pseudo, 2)
        ds.set_cross_domain()
        assert ds.cross_domain and ds.num_train_pids == 5
    np.testing.assert_array_equal(mine.get_class_stats(),
                                  ref.get_class_stats())
    np.testing.assert_array_equal(mine.labels, ref.labels)
    idx = np.arange(12)
    np.testing.assert_array_equal(mine.gather(idx)["weights"],
                                  ref.gather(idx)["weights"])
    assert mine.flags == [0] * 12 + [1] * 3
