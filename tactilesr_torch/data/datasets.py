"""Dataset classes, stacked into contiguous numpy arrays (the port's copy
of ``tactilesr_tpu/data/datasets.py``): ``TPSFNetDataset`` and
``SingleTapSeqsDataset`` over raw blobs, ``TactileSRDataset`` and
``TactileSRDatasetSeq`` over generated SR pairs.

SR pairs come in two formats: a ``.npz`` with stacked ``LR`` and ``HR``
arrays (what ``generate single|seqs`` writes), and the reference
generator's legacy object-``.npy`` of singleton records holding ``LR`` and
``HR`` (numpy arrays or torch tensors), read through pickle.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np

from .raw_process import load_raw_dataset

__all__ = ["TPSFNetDataset", "TactileSRDataset", "TactileSRDatasetSeq", "SingleTapSeqsDataset"]


def _to_numpy(x) -> np.ndarray:
    # legacy records may hold tensors (saved by torch on another machine)
    if hasattr(x, "detach"):
        x = x.detach()
    if hasattr(x, "cpu"):
        x = x.cpu()
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(x)


class _StackedPairs:
    """List-style access plus stacked-array access."""

    def __len__(self):
        return self._a.shape[0]

    def __getitem__(self, idx):
        return np.ascontiguousarray(self._a[idx]), np.ascontiguousarray(self._b[idx])

    def stacked(self):
        """(first_array, second_array) as contiguous stacked numpy arrays."""
        return self._a, self._b


class TPSFNetDataset(_StackedPairs):
    """(LR (3,4,4), depth (100,100)) pairs from a directory of raw blobs,
    walked in sorted order."""

    def __init__(self, dataset_dir: str, sample_cnt: int,
                 is_sample_idx: Union[Sequence[int], int, None], is_aug_data: bool = True):
        samples: List[dict] = []
        for root, _dirs, files in os.walk(dataset_dir):
            for f in sorted(files):
                if os.path.splitext(f)[1] == ".npy":
                    samples += load_raw_dataset(
                        os.path.join(root, f), sample_cnt=sample_cnt,
                        is_sample_idx=is_sample_idx, is_aug_data=is_aug_data,
                    )
        if not samples:
            self._a = np.zeros((0, 3, 4, 4), np.float32)
            self._b = np.zeros((0, 100, 100), np.float32)
        else:
            self._a = np.ascontiguousarray(np.stack([s["LR"] for s in samples]).astype(np.float32))
            self._b = np.ascontiguousarray(np.stack([s["depth"] for s in samples]).astype(np.float32))


def _load_sr_pairs(path: str):
    """(LR, HR) f32 stacks from a ``.npz`` or a legacy object ``.npy``."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SR dataset not found: {path}\n"
            "Generate it from a trained tPSFNet checkpoint, e.g.:\n"
            "  python -m tactilesr_torch.data.generate single "
            "--tpsf-checkpoint <pth> --raw-dir <rotateDataset> --out-dir <dir>\n"
            "(or 'seqs' for the multi-frame dataset; 'synthetic' fabricates "
            "raw blobs when no sensor recordings are available)"
        )
    if path.endswith(".npz"):
        with np.load(path) as z:
            return (np.ascontiguousarray(z["LR"].astype(np.float32)),
                    np.ascontiguousarray(z["HR"].astype(np.float32)))
    raw = np.load(path, allow_pickle=True)
    lrs, hrs = [], []
    for rec in raw:
        item = rec
        # legacy rows are singleton object arrays or lists wrapping the dict
        while not isinstance(item, dict):
            if hasattr(item, "item") and getattr(item, "size", 2) == 1:
                item = item.item()
            elif isinstance(item, (list, tuple, np.ndarray)):
                item = item[0]
            else:
                break
        lrs.append(_to_numpy(item["LR"]))
        hrs.append(_to_numpy(item["HR"]))
    return (np.ascontiguousarray(np.stack(lrs).astype(np.float32)),
            np.ascontiguousarray(np.stack(hrs).astype(np.float32)))


class TactileSRDataset(_StackedPairs):
    """(LR (C,4,4), HR (1,100,100)) pairs; C=3 single-frame."""

    def __init__(self, dataset_path: str):
        self._a, self._b = _load_sr_pairs(dataset_path)


class TactileSRDatasetSeq(TactileSRDataset):
    """The same access over the multi-frame SeqsDataset (C=21); a class of
    its own to mirror the reference API."""


class SingleTapSeqsDataset(_StackedPairs):
    """One tap's press sequence (for the alpha/beta-vs-force inference plots)."""

    def __init__(self, dataset_file: str, is_sample_idx=6, sample_cnt: int = 10):
        # a bare int would select every tap in load_raw_dataset (its
        # selection takes lists only); the class documents one tap
        if isinstance(is_sample_idx, (int, np.integer)):
            is_sample_idx = [int(is_sample_idx)]
        samples = load_raw_dataset(dataset_file, sample_cnt=sample_cnt, is_sample_idx=is_sample_idx)
        if not samples:
            raise ValueError(
                f"SingleTapSeqsDataset: tap index {is_sample_idx} selected "
                f"no samples from {dataset_file!r} (out of range, or the "
                "tap has no pre-peak contact frames)"
            )
        self._a = np.ascontiguousarray(np.stack([s["LR"] for s in samples]).astype(np.float32))
        self._b = np.ascontiguousarray(np.stack([s["depth"] for s in samples]).astype(np.float32))
