"""Filename-regex dataset parsers producing (path, pid, camid, seqid) tuples.

An own copy of `reid_tpu/data/datasets.py` (pure Python, unchanged), so
that the port imports nothing of the JAX package; `write_synthetic_tree`
writes a colour-separable split in the Market-1501 or DukeMTMC-reID
layout that they read (training smoke runs and tests).

Exact semantics of ref `reid/datasets/`:
  Market1501 (dataset_market.py:7-81): `([-\\d]+)_c(\\d)s(\\d)` over *.jpg in
    bounding_box_train/query/bounding_box_test; pid -1 junk skipped; relabel
    on train; camid/seqid made 0-based; 6 cams.
  DukeMTMC (dataset_dukemtmc.py:16-91): `([-\\d]+)_c(\\d)` under DukeMTMC-reID/;
    8 cams; seqid fixed 0.
  VeRi-776 (dataset_veri776.py:13-91): `([-\\d]+)_c([-\\d]+)` under VeRi/;
    20 cams; aspect ratio 224x224 (get_ratio :51-52).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

Record = Tuple[str, int, int, int]  # (path, pid, camid, seqid)


class BaseImageDataset:
    """Stats helpers. Ref base_dataset.py:1-55."""

    train: List[Record]
    query: List[Record]
    gallery: List[Record]

    @staticmethod
    def get_imagedata_info(data: List[Record]):
        pids = {r[1] for r in data}
        cams = {r[2] for r in data}
        seqs = {r[3] for r in data}
        return len(pids), len(data), len(cams), len(seqs)

    def get_ratio(self) -> float:
        """Target aspect w/h for the transform chain (ref veri :51-52)."""
        return 0.5

    def print_dataset_statistics(self):
        rows = [("train", self.train), ("query", self.query),
                ("gallery", self.gallery)]
        print("Dataset statistics:")
        print("  subset   | # ids | # images | # cameras | # sequences")
        for name, data in rows:
            p, i, c, s = self.get_imagedata_info(data)
            print(f"  {name:<8} | {p:5d} | {i:8d} | {c:9d} | {s:9d}")

    def _finalize(self, verbose: bool):
        (self.num_train_pids, self.num_train_imgs, self.num_train_cams,
         self.num_train_seqs) = self.get_imagedata_info(self.train)
        (self.num_query_pids, self.num_query_imgs, self.num_query_cams,
         self.num_query_seqs) = self.get_imagedata_info(self.query)
        (self.num_gallery_pids, self.num_gallery_imgs, self.num_gallery_cams,
         self.num_gallery_seqs) = self.get_imagedata_info(self.gallery)
        if verbose:
            self.print_dataset_statistics()


def _process_dir(dir_path: str, pattern: re.Pattern, relabel: bool,
                 cam_range: Tuple[int, int], has_seq: bool,
                 max_pid: int | None = None) -> List[Record]:
    img_paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pid_container = set()
    for p in img_paths:
        m = pattern.search(p)
        pid = int(m.group(1))
        if pid == -1:
            continue
        pid_container.add(pid)
    pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}

    dataset: List[Record] = []
    for p in img_paths:
        m = pattern.search(p)
        groups = [int(g) for g in m.groups()]
        pid, camid = groups[0], groups[1]
        seqid = groups[2] if has_seq else 1
        if pid == -1:
            continue
        if max_pid is not None:
            assert 0 <= pid <= max_pid, p
        assert cam_range[0] <= camid <= cam_range[1], p
        if relabel:
            pid = pid2label[pid]
        dataset.append((p, pid, camid - 1, seqid - 1))
    return dataset


class Market1501(BaseImageDataset):
    """Ref dataset_market.py:7-81."""

    def __init__(self, root: str, verbose: bool = True):
        d = root
        self.train = _process_dir(
            osp.join(d, "bounding_box_train"),
            re.compile(r"([-\d]+)_c(\d)s(\d)"), True, (1, 6), True, 1501)
        self.query = _process_dir(
            osp.join(d, "query"),
            re.compile(r"([-\d]+)_c(\d)s(\d)"), False, (1, 6), True, 1501)
        self.gallery = _process_dir(
            osp.join(d, "bounding_box_test"),
            re.compile(r"([-\d]+)_c(\d)s(\d)"), False, (1, 6), True, 1501)
        self._finalize(verbose)


class DukeMTMC(BaseImageDataset):
    """Ref dataset_dukemtmc.py:16-91."""

    def __init__(self, root: str, verbose: bool = True):
        d = osp.join(root, "DukeMTMC-reID")
        pat = re.compile(r"([-\d]+)_c(\d)")
        self.train = _process_dir(
            osp.join(d, "bounding_box_train"), pat, True, (1, 8), False)
        self.query = _process_dir(
            osp.join(d, "query"), pat, False, (1, 8), False)
        self.gallery = _process_dir(
            osp.join(d, "bounding_box_test"), pat, False, (1, 8), False)
        self._finalize(verbose)


class VeRi776(BaseImageDataset):
    """Ref dataset_veri776.py:13-91."""

    def __init__(self, root: str, verbose: bool = True):
        d = osp.join(root, "VeRi")
        pat = re.compile(r"([-\d]+)_c([-\d]+)")
        self.train = _process_dir(
            osp.join(d, "image_train"), pat, True, (1, 20), False, 776)
        self.query = _process_dir(
            osp.join(d, "image_query"), pat, False, (1, 20), False, 776)
        self.gallery = _process_dir(
            osp.join(d, "image_test"), pat, False, (1, 20), False, 776)
        self._finalize(verbose)

    def get_ratio(self) -> float:
        return 1.0  # VeRi uses square 224x224 inputs (ref data_transforms.py)


def build_dataset(name: str, root: str, verbose: bool = True) -> BaseImageDataset:
    table = {"market1501": Market1501, "dukemtmc": DukeMTMC, "veri": VeRi776}
    if name not in table:
        raise KeyError(f"unknown dataset '{name}'; have {sorted(table)}")
    return table[name](root, verbose)


def write_synthetic_tree(root: str, layout: str, num_pids: int,
                         per_id, height: int = 256, width: int = 128,
                         num_cams: int = 6, query_per_id: int = 0,
                         gallery_per_id: int = 0, seed: int = 0) -> str:
    """Write colour-separable identities as JPEGs that `build_dataset(
    layout, root)` reads: ids 1..num_pids with `per_id` train images each
    (or per_id[i] for id i + 1), `query_per_id` query and `gallery_per_id`
    gallery images each. An
    identity is two colours, the upper and the lower half of the image,
    drawn from `np.random.default_rng(seed)`, with uniform noise of +-25
    per pixel; train and gallery image k of an id are seen by camera
    k % num_cams + 1, query image k by the next camera. File names follow
    "market1501" ({pid:04d}_c{cam}s1_{k:06d}_00.jpg under root) or
    "dukemtmc" ({pid:04d}_c{cam}_f{k:07d}.jpg under root/DukeMTMC-reID).
    The pixels are drawn id by id on the calling thread; a pool of threads
    encodes the JPEGs."""
    from PIL import Image

    if layout not in ("market1501", "dukemtmc"):
        raise KeyError(f"no synthetic layout '{layout}'")
    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 226, (num_pids, 2, 3))
    base = root if layout == "market1501" else osp.join(root,
                                                         "DukeMTMC-reID")
    counts = np.broadcast_to(per_id, (num_pids,))
    splits = {"bounding_box_train": counts,
              "query": [query_per_id] * num_pids,
              "bounding_box_test": [gallery_per_id] * num_pids}
    half = height // 2

    def write(job):
        path, img = job
        Image.fromarray(img).save(path)

    with ThreadPoolExecutor(max(os.cpu_count() or 1, 1)) as pool:
        pending = []
        for sub, count in splits.items():
            os.makedirs(osp.join(base, sub), exist_ok=True)
            for pid in range(1, num_pids + 1):
                n = int(count[pid - 1])
                img = rng.integers(-25, 26, (n, height, width, 3),
                                   dtype=np.int16)
                img[:, :half] += colors[pid - 1, 0].astype(np.int16)
                img[:, half:] += colors[pid - 1, 1].astype(np.int16)
                img = np.clip(img, 0, 255).astype(np.uint8)
                for k in range(n):
                    cam = (k + (sub == "query")) % num_cams + 1
                    name = (f"{pid:04d}_c{cam}s1_{k:06d}_00.jpg"
                            if layout == "market1501"
                            else f"{pid:04d}_c{cam}_f{k:07d}.jpg")
                    pending.append(pool.submit(
                        write, (osp.join(base, sub, name), img[k])))
        for f in pending:
            f.result()
    return root
