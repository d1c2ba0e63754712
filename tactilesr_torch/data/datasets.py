"""Dataset classes over raw blobs, stacked into contiguous numpy arrays
(the port's copy of ``tactilesr_tpu/data/datasets.py``'s raw-blob part:
``TPSFNetDataset`` and ``SingleTapSeqsDataset``)."""

from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np

from .raw_process import load_raw_dataset

__all__ = ["TPSFNetDataset", "SingleTapSeqsDataset"]


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
