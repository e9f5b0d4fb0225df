"""ReIDDataset — host-side record store with an image cache.

Counterpart of `reid_tpu/data/dataset.py` for evaluation: records, the
decode-once uint8 cache in memory, batch decoding of JPEGs by the native
libjpeg loader (`reid_tpu_torch.native`, PIL otherwise), and `preload` for
in-memory splits. Images decode exactly as the JAX module decodes them, so
both packages see the same pixels. The continual-training parts (pseudo
labels, per-sample weights, class stats) and the h5py image cache, which
nothing of this slice asks for, belong to later slices. PIL is imported
only when used.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Record = Tuple[str, int, int, int]   # (path, pid, camid, seqid)
_SYNTH_CHUNK = 128      # synthetic images whose noise is drawn in one call


class ReIDDataset:
    def __init__(self, records: Sequence[Record], num_pids: int,
                 height: int = 256, width: int = 128):
        self.records: List[Record] = list(records)
        self.num_train_pids = num_pids
        self.height = height
        self.width = width
        self._cache: dict = {}

    def __len__(self):
        return len(self.records)

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
        """uint8 (H, W, 3), resized once (PIL bilinear) and cached."""
        if index in self._cache:
            return self._cache[index]
        from PIL import Image

        with Image.open(self.records[index][0]) as im:
            arr = np.asarray(im.convert("RGB").resize(
                (self.width, self.height), Image.BILINEAR), np.uint8)
        self._cache[index] = arr
        return arr

    def _decode_batch_native(self, indices: Sequence[int]) -> dict:
        """Batch-decode uncached JPEGs with the C++ loader; {index: array},
        empty when the native loader is unavailable (then PIL decodes)."""
        missing = [i for i in indices if i not in self._cache]
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
        """Host batch: uint8 images (B, H, W, 3) and int32 labels, cams,
        seqs."""
        decoded = self._decode_batch_native(indices)
        images = np.stack([decoded[i] if i in decoded else self.load_image(i)
                           for i in indices])
        recs = [self.records[i] for i in indices]
        return {
            "images": images,
            "labels": np.asarray([r[1] for r in recs], np.int32),
            "cams": np.asarray([r[2] for r in recs], np.int32),
            "seqs": np.asarray([r[3] for r in recs], np.int32),
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
