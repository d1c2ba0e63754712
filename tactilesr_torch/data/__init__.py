"""Data: synthetic raw blobs, raw preprocessing, datasets, SR-dataset
generation (``data/generate.py``, imported on its own: it pulls in the
model stack)."""

from .datasets import SingleTapSeqsDataset, TactileSRDataset, TactileSRDatasetSeq, TPSFNetDataset
from .loader import epoch_batches
from .raw_process import (
    augment_rotations,
    binarize_depth,
    extract_contact_seqs,
    load_raw_dataset,
    load_seq_dataset_sr,
    scale_depth_by_force,
)
from .synthetic import generate_rotate_dataset, make_tap_record, write_raw_blob

__all__ = [
    "TPSFNetDataset",
    "TactileSRDataset",
    "TactileSRDatasetSeq",
    "SingleTapSeqsDataset",
    "epoch_batches",
    "extract_contact_seqs",
    "binarize_depth",
    "augment_rotations",
    "scale_depth_by_force",
    "load_raw_dataset",
    "load_seq_dataset_sr",
    "generate_rotate_dataset",
    "make_tap_record",
    "write_raw_blob",
]
