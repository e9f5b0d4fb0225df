"""Filename-regex dataset parsers producing (path, pid, camid, seqid) tuples.

An own copy of `reid_tpu/data/datasets.py` (pure Python, unchanged), so
that the port imports nothing of the JAX package.

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
import os.path as osp
import re
from dataclasses import dataclass, field
from typing import List, Tuple

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
