"""The port's host-side extra augmentations (`data/augment_extra.py`) and
the HDF5 image cache of its `ReIDDataset` against the JAX package's, on
uint8 images and JPEG trees made from a seed.

  * `to_sketch` with OpenCV's Gaussian blur and with the NumPy box blur of
    the machines without `cv2` (the card's machine has none): bit-equal;
  * `fuse_rgb_gray_sketch` over 30 draws of one `random.Random` seed:
    bit-equal, and at least two of its three variants drawn;
  * `grabcut_foreground` with `cv2.setRNGSeed(0)` before each grabCut,
    and the all-ones mask without `cv2`: bit-equal;
  * `OcclusionAugment` with and without the foreground mask, one seed, a
    run of indices (donors, strip sizes, top or bottom): bit-equal;
  * `ReIDDataset(hdf5_cache=)`: the first read (decode, write-through)
    and, with the JPEGs deleted, the second read from the file (by a new
    dataset on it) bit-equal to JAX's decode; the port reads a cache
    that the JAX package wrote, and the reverse.
"""

import os
import random

import numpy as np
import pytest
from PIL import Image

from reid_tpu.data import augment_extra as jae
from reid_tpu.data.dataset import ReIDDataset as JDataset
from reid_tpu_torch.data import augment_extra as tae
from reid_tpu_torch.data.dataset import ReIDDataset as TDataset
from test_torch_train_data import two_torch_threads  # noqa: F401

needs_cv2 = pytest.mark.skipif(not (jae._HAS_CV2 and tae._HAS_CV2),
                               reason="OpenCV is not installed")


def person_like(rng, h=64, w=32):
    """A figure on a textured background, so that grabCut has a
    foreground to find."""
    img = rng.integers(0, 80, (h, w, 3), np.uint8)
    img[h // 8:h - h // 8, w // 4:w - w // 4] = rng.integers(
        150, 255, 3, np.uint8)
    return img


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Eight JPEGs of 64x32: four ids, two cameras."""
    root = tmp_path_factory.mktemp("occ")
    rng = np.random.default_rng(4)
    records = []
    for i in range(8):
        path = str(root / f"{i}.jpg")
        Image.fromarray(person_like(rng)).save(path)
        records.append((path, i % 4, i % 2, 0))
    return records


@pytest.mark.parametrize("cv2", [True, False])
def test_to_sketch_matches_jax(monkeypatch, cv2):
    if cv2 and not (jae._HAS_CV2 and tae._HAS_CV2):
        pytest.skip("OpenCV is not installed")
    monkeypatch.setattr(jae, "_HAS_CV2", cv2)
    monkeypatch.setattr(tae, "_HAS_CV2", cv2)
    img = np.random.default_rng(0).integers(0, 255, (64, 32, 3), np.uint8)
    want = jae.to_sketch(img)
    got = tae.to_sketch(img)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_fuse_rgb_gray_sketch_matches_jax():
    img = np.random.default_rng(1).integers(0, 255, (64, 32, 3), np.uint8)
    ra, rb = random.Random(3), random.Random(3)
    outs = set()
    for _ in range(30):
        want = jae.fuse_rgb_gray_sketch(img, ra)
        got = tae.fuse_rgb_gray_sketch(img, rb)
        np.testing.assert_array_equal(got, want)
        outs.add(got.tobytes())
    assert len(outs) >= 2


@pytest.mark.parametrize("cv2", [True, False])
def test_grabcut_foreground_matches_jax(monkeypatch, cv2):
    if cv2 and not (jae._HAS_CV2 and tae._HAS_CV2):
        pytest.skip("OpenCV is not installed")
    monkeypatch.setattr(jae, "_HAS_CV2", cv2)
    monkeypatch.setattr(tae, "_HAS_CV2", cv2)
    img = person_like(np.random.default_rng(2))
    masks = []
    for mod in (jae, tae):
        if cv2:
            mod.cv2.setRNGSeed(0)
        masks.append(mod.grabcut_foreground(img))
    np.testing.assert_array_equal(masks[1], masks[0])
    assert masks[1].shape == img.shape[:2] and masks[1].dtype == np.uint8
    if not cv2:
        assert masks[1].all()


@pytest.mark.parametrize("foreground", [False, pytest.param(
    True, marks=needs_cv2)])
def test_occlusion_augment_matches_jax(tree, foreground):
    ja = jae.OcclusionAugment(tree, foreground=foreground, seed=5)
    ta = tae.OcclusionAugment(tree, foreground=foreground, seed=5)
    changed = 0
    for index in (0, 3, 5, 6, 1, 2):
        if foreground:
            jae.cv2.setRNGSeed(0)
        want = ja(index)
        if foreground:
            tae.cv2.setRNGSeed(0)
        got = ta(index)
        np.testing.assert_array_equal(got, want)
        with Image.open(tree[index][0]) as im:
            changed += not np.array_equal(got, np.asarray(im.convert("RGB")))
    assert changed >= 4


def test_hdf5_cache_matches_jax(tree, tmp_path):
    pytest.importorskip("h5py")
    records = [(str(tmp_path / f"{i}.jpg"), pid, cam, seq)
               for i, (_, pid, cam, seq) in enumerate(tree)]
    for (src, *_), (dst, *_) in zip(tree, records):
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read())
    want = [JDataset(records, 4, 48, 24, cache=False).load_image(i)
            for i in range(len(records))]
    t_path, j_path = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    first = TDataset(records, 4, 48, 24, hdf5_cache=t_path)
    jfirst = JDataset(records, 4, 48, 24, cache=False, hdf5_cache=j_path)
    for i in range(len(records)):
        np.testing.assert_array_equal(first.load_image(i), want[i])
        jfirst.load_image(i)
    del first, jfirst
    for path, *_ in records:        # the second reads cannot decode
        os.remove(path)
    for path in (t_path, j_path):   # each package reads both files
        again = TDataset(records, 4, 48, 24, hdf5_cache=path)
        jagain = JDataset(records, 4, 48, 24, cache=False, hdf5_cache=path)
        for i in range(len(records)):
            np.testing.assert_array_equal(again.load_image(i), want[i])
            np.testing.assert_array_equal(jagain.load_image(i), want[i])
        np.testing.assert_array_equal(
            again.gather([3, 1])["images"], np.stack([want[3], want[1]]))
        del again, jagain
