"""ReIDDataset — host-side record store with an image cache.

Counterpart of `reid_tpu/data/dataset.py`: records, the decode-once uint8
cache in memory, batch decoding of JPEGs by the native libjpeg loader
(`reid_tpu_torch.native`, PIL otherwise), `preload` for in-memory splits,
and the continual phase's pseudo labels (`add_pseudo`, the per-sample
flags that `gather` returns as "weights", `set_cross_domain`) and class
stats. Images decode exactly as the JAX module decodes them, so both
packages see the same pixels. `hdf5_cache=path` keeps the decoded images
in an HDF5 file as well (ref train_utils.py:26-42): an "images" array
written lazily on each image's first decode and a "done" mask, so a
later run (or another dataset on the same file) reads them back instead
of decoding. PIL and h5py are imported only when used.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

Record = Tuple[str, int, int, int]   # (path, pid, camid, seqid)
_SYNTH_CHUNK = 128      # synthetic images whose noise is drawn in one call
_DECODE_THREADS = 8     # PIL decodes of one batch in flight


class ReIDDataset:
    def __init__(self, records: Sequence[Record], num_pids: int,
                 height: int = 256, width: int = 128, hdf5_cache: str = ""):
        self.records: List[Record] = list(records)
        self.num_train_pids = num_pids
        self.height = height
        self.width = width
        # per-sample weight flag: 0 = real, 1 = pseudo (ref :89)
        self.flags: List[int] = [0] * len(self.records)
        self.cross_domain = False
        self._cache: dict = {}
        self._h5 = None
        if hdf5_cache:
            import h5py
            self._h5 = h5py.File(hdf5_cache, "a")
            self._h5ds = self._h5.require_dataset(
                "images", shape=(len(self.records), height, width, 3),
                dtype="uint8")
            self._h5done = self._h5.require_dataset(
                "done", shape=(len(self.records),), dtype="uint8")

    def __len__(self):
        return len(self.records)

    def add_pseudo(self, pseudo_records: Sequence[Record], num_new: int):
        """Append pseudo-labelled samples, flagged 1; their pids come
        offset by the caller (ref add_pseudo :51-67)."""
        self.records.extend(pseudo_records)
        self.flags.extend([1] * len(pseudo_records))
        self.num_train_pids += num_new

    def set_cross_domain(self):
        self.cross_domain = True

    def get_class_stats(self) -> np.ndarray:
        """Per-class sample counts, at least 1 (ref image_reid_train.py:
        40-41)."""
        counts = np.bincount(self.labels, minlength=self.num_train_pids)
        return np.maximum(counts, 1)

    @property
    def labels(self) -> np.ndarray:
        return np.asarray([r[1] for r in self.records], np.int64)

    @property
    def cams(self) -> np.ndarray:
        return np.asarray([r[2] for r in self.records], np.int64)

    @property
    def seqs(self) -> np.ndarray:
        return np.asarray([r[3] for r in self.records], np.int64)

    def load_image(self, index: int) -> np.ndarray:
        """uint8 (H, W, 3), resized once (PIL bilinear) and cached: from
        memory, else from the HDF5 cache where it holds the image, else
        decoded (and written to the HDF5 cache)."""
        if index in self._cache:
            return self._cache[index]
        if self._h5 is not None and self._h5done[index]:
            return self._h5ds[index]
        from PIL import Image

        with Image.open(self.records[index][0]) as im:
            arr = np.asarray(im.convert("RGB").resize(
                (self.width, self.height), Image.BILINEAR), np.uint8)
        if self._h5 is not None:
            self._h5ds[index] = arr
            self._h5done[index] = 1
        self._cache[index] = arr
        return arr

    def _decode_batch_native(self, indices: Sequence[int]) -> dict:
        """Batch-decode uncached JPEGs with the C++ loader; {index: array},
        empty when the native loader is unavailable (then PIL decodes).
        Images that the HDF5 cache holds are read from it instead."""
        missing = [i for i in indices if i not in self._cache and not (
            self._h5 is not None and self._h5done[i])]
        if not missing:
            return {}
        paths = [self.records[i][0] for i in missing]
        if not all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            return {}
        try:
            from .. import native
            if not native.available():
                return {}
            batch = native.decode_batch(paths, self.height, self.width)
        except Exception:
            return {}
        decoded = dict(zip(missing, batch))
        self._cache.update(decoded)
        return decoded

    def preload(self, images: Sequence[np.ndarray]):
        """Inject decoded images directly (in-memory splits), bypassing file
        IO."""
        for i, arr in enumerate(images):
            self._cache[i] = np.asarray(arr, np.uint8)
        return self

    def gather(self, indices: Sequence[int]) -> dict:
        """Host batch: uint8 images (B, H, W, 3), int32 labels, cams and
        seqs, and the f32 pseudo flags as "weights". Images the native
        loader does not decode are decoded by PIL on `_DECODE_THREADS`
        threads (PIL releases the interpreter lock while it decodes)."""
        decoded = self._decode_batch_native(indices)
        missing = [i for i in dict.fromkeys(int(i) for i in indices)
                   if i not in decoded and i not in self._cache]
        if len(missing) > 1:
            with ThreadPoolExecutor(_DECODE_THREADS) as pool:
                list(pool.map(self.load_image, missing))
        images = np.stack([decoded[i] if i in decoded else self.load_image(i)
                           for i in indices])
        recs = [self.records[i] for i in indices]
        return {
            "images": images,
            "labels": np.asarray([r[1] for r in recs], np.int32),
            "cams": np.asarray([r[2] for r in recs], np.int32),
            "seqs": np.asarray([r[3] for r in recs], np.int32),
            "weights": np.asarray([float(self.flags[i]) for i in indices],
                                  np.float32),
        }


def synthetic_dataset(n: int = 16, num_pids: int = 4, height: int = 32,
                      width: int = 16, num_cams: int = 2, seed: int = 0,
                      palette_seed: int = 0) -> ReIDDataset:
    """In-memory colour-separable synthetic split: the records and pixels of
    `reid_tpu.data.synthetic_dataset` with the same arguments (a test holds
    them equal). `palette_seed` fixes identity colours across query and
    gallery. The noise of `_SYNTH_CHUNK` images is drawn in one call (the
    same stream as one call per image) and the images are written straight
    into one uint8 array."""
    rng = np.random.default_rng(seed)
    palette = np.random.default_rng(palette_seed).integers(
        40, 220, (num_pids, 3))
    records = [(f"<synthetic-{i}>", i % num_pids, i % num_cams, 0)
               for i in range(n)]
    images = np.empty((n, height, width, 3), np.uint8)
    for s in range(0, n, _SYNTH_CHUNK):
        e = min(n, s + _SYNTH_CHUNK)
        v = rng.integers(-25, 25, (e - s, height, width, 3))
        v += palette[np.arange(s, e) % num_pids][:, None, None, :]
        images[s:e] = np.clip(v, 0, 255, out=v)
    return ReIDDataset(records, num_pids, height, width).preload(images)
