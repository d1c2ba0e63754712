"""Raw rotateDataset processing: contact-sequence extraction, depth
binarization, rotation augmentation.

The port's copy of ``tactilesr_tpu/data/raw_process.py`` (reference
utility/raw_data_process.py).  ``extract_contact_seqs`` and
``binarize_depth`` run the C++ versions of ``tactilesr_torch/native``
unless ``TACTILESR_NATIVE=0`` or the library did not build, and numpy
otherwise, as the JAX package dispatches:

- ``extract_contact_seqs``: find the peak-force frame by z-sum, keep the
  pre-peak frames whose z-sum exceeds ``threshold_scale`` x peak, flip each
  4x4 map vertically, subsample uniformly to ``sample_count`` frames.
- ``binarize_depth``: the reference's two sequential in-place thresholds,
  then a bilinear resize to ``depth_pixel`` with the torch-exact matrices.
- ``augment_rotations``: x4 via joint rot90 of LR channels and depth.
- ``scale_depth_by_force``: depth *= sum(LR_z) * 0.01, in place.
- ``load_raw_dataset``: one ``.npy`` of tap dicts -> flat samples.
- ``load_seq_dataset_sr``: rot0/rot30 tap pairs over the 9-position grid.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np

from ..ops.resize import bilinear_resize_matrix

__all__ = [
    "frames_to_maps",
    "extract_contact_seqs",
    "binarize_depth",
    "augment_rotations",
    "scale_depth_by_force",
    "load_raw_dataset",
    "load_seq_dataset_sr",
]


def _use_native() -> bool:
    """The C++ preprocessing unless ``TACTILESR_NATIVE=0`` or it did not
    build (then numpy, which gives the same results)."""
    if os.environ.get("TACTILESR_NATIVE", "1") == "0":
        return False
    from .. import native

    return native.available()


def frames_to_maps(tactile_lrs: np.ndarray) -> np.ndarray:
    """(seqs, 48) raw taxel frames -> (seqs, 3, 4, 4) [x, y, z] force maps,
    each 4x4 map flipped vertically (sensor orientation)."""
    seqs = tactile_lrs.shape[0]
    maps = tactile_lrs.reshape(seqs, 16, 3).transpose(0, 2, 1).reshape(seqs, 3, 4, 4)
    return maps[:, :, ::-1, :]


def extract_contact_seqs(tactile_lrs: np.ndarray, threshold_scale: float = 0.1,
                         sample_count: int = -1) -> np.ndarray:
    """Pre-peak contact frames from one tap, as (n, 3, 4, 4).

    The peak is the first frame with the largest z-sum; kept frames lie
    before it with z-sum above ``threshold_scale`` x peak.
    """
    tactile_lrs = np.asarray(tactile_lrs)
    if _use_native():
        from ..native import extract_contact_seqs_native

        return extract_contact_seqs_native(tactile_lrs, threshold_scale, sample_count)
    maps = frames_to_maps(tactile_lrs)
    z_sums = maps[:, 2].sum(axis=(1, 2))

    peak = 0.0
    peak_idx = 0
    for i, s in enumerate(z_sums):
        if s > peak:
            peak = s
            peak_idx = i

    kept = maps[np.nonzero(z_sums[:peak_idx] > peak * threshold_scale)[0]]
    if sample_count > 0 and kept.shape[0] > 0:
        n = min(sample_count, kept.shape[0])
        kept = kept[np.linspace(0, kept.shape[0] - 1, n).astype(np.int16)]
    return np.ascontiguousarray(kept)


def binarize_depth(depth: np.ndarray, depth_pixel: int = 100) -> np.ndarray:
    """Two-pass midpoint binarization, then bilinear resize to depth_pixel^2.

    Pass 1 sets values above the midpoint to 1; pass 2 recomputes the
    midpoint on the modified array and zeros everything not above it.
    """
    if _use_native():
        from ..native import binarize_depth_native

        return binarize_depth_native(np.asarray(depth, np.float32), depth_pixel)
    d = np.array(depth, dtype=np.float32, copy=True)
    t1 = d.min() * 0.5 + d.max() * 0.5
    d[d > t1] = 1.0
    t2 = d.min() * 0.5 + d.max() * 0.5
    d[~(d > t2)] = 0.0
    if d.shape != (depth_pixel, depth_pixel):
        wh = bilinear_resize_matrix(d.shape[0], depth_pixel)
        ww = bilinear_resize_matrix(d.shape[1], depth_pixel)
        d = wh @ d @ ww.T
    return d.astype(np.float32)


def scale_depth_by_force(samples: List[dict]) -> List[dict]:
    """In place: depth *= sum(LR_z) * 0.01, the reference's ``depth2tactile``
    dataset scaler (utility/raw_data_process.py:52-55); returns ``samples``."""
    for s in samples:
        s["depth"] = s["depth"] * s["LR"][2].sum() * 0.01
    return samples


def augment_rotations(samples: List[dict]) -> List[dict]:
    """x4 dataset: original plus joint rot90/180/270 of LR channels and depth."""
    out: List[dict] = []
    for s in samples:
        out.append({"LR": s["LR"], "depth": s["depth"]})
        for k in (1, 2, 3):
            lr = np.stack([np.rot90(s["LR"][c], k) for c in range(s["LR"].shape[0])])
            out.append({"LR": lr, "depth": np.rot90(s["depth"], k)})
    return out


def load_raw_dataset(dataset_filepath: str, sample_cnt: int,
                     is_sample_idx: Union[Sequence[int], int, None] = None,
                     idx_threshold_scale: float = 0.3, depth_pixel: int = 100,
                     is_aug_data: bool = False) -> List[dict]:
    """One raw ``.npy`` of tap dicts -> ``{LR (3,4,4), depth (100,100)}`` samples.

    A list ``is_sample_idx`` selects taps by index, which requires every tap
    to contribute exactly ``sample_cnt`` samples (else ValueError).
    """
    raw = np.load(dataset_filepath, allow_pickle=True)
    samples: List[dict] = []
    short_taps: List[tuple] = []
    for tap_no, rec in enumerate(raw):
        rec = rec.item() if hasattr(rec, "item") and not isinstance(rec, dict) else rec
        depth = binarize_depth(np.asarray(rec["depth"]), depth_pixel)
        lr_seqs = extract_contact_seqs(np.asarray(rec["LRs"]), idx_threshold_scale, sample_cnt)
        if sample_cnt > 0 and lr_seqs.shape[0] != sample_cnt:
            short_taps.append((tap_no, lr_seqs.shape[0]))
        for i in range(lr_seqs.shape[0]):
            samples.append({"LR": lr_seqs[i], "depth": depth})

    if isinstance(is_sample_idx, (list, tuple, np.ndarray)):
        if short_taps:
            raise ValueError(
                f"{dataset_filepath}: tap-index selection requires every tap "
                f"to contribute exactly sample_cnt={sample_cnt} samples, but "
                f"{len(short_taps)} tap(s) fell short (tap, n): {short_taps[:5]}"
                f"{' ...' if len(short_taps) > 5 else ''} -- lower sample_cnt "
                "or drop the tap from the blob"
            )
        picked: List[dict] = []
        for idx in is_sample_idx:
            if idx < 0:
                raise ValueError(f"sample index must be >= 0, got {idx}")
            picked += samples[idx * sample_cnt:(idx + 1) * sample_cnt]
        samples = picked

    if is_aug_data:
        samples = augment_rotations(samples)
    return samples


def load_seq_dataset_sr(dataset_filepath: str, sample_cnt: int, idx_threshold_scale: float = 0.3,
                        depth_pixel: int = 100) -> List[dict]:
    """Rot0/rot30 tap pairs over the 9-position grid (the reference's
    loadSeqDataset_SR, which its pipeline never calls): for position i the
    pairs (4i + j, 4i + j + 1), j < 3, and (4i + 2, 4i + 1) give
    ``{LR_0 (3,4,4): the first tap's last contact frame, LR_1 (3,4,4): each
    contact frame of the second, depth: the second tap's map}``; a first
    tap without contact frames gives nothing."""
    raw = np.load(dataset_filepath, allow_pickle=True)

    def tap(i):
        rec = raw[i]
        return rec.item() if hasattr(rec, "item") and not isinstance(rec, dict) else rec

    out: List[dict] = []
    for i in range(9):
        pairs = [(4 * i + j, 4 * i + j + 1) for j in range(3)] + [(4 * i + 2, 4 * i + 1)]
        for idx0, idx30 in pairs:
            rec0, rec30 = tap(idx0), tap(idx30)
            depth = binarize_depth(np.asarray(rec30["depth"]), depth_pixel)
            lr0 = extract_contact_seqs(np.asarray(rec0["LRs"]), idx_threshold_scale, sample_cnt)
            lr_seqs = extract_contact_seqs(np.asarray(rec30["LRs"]), idx_threshold_scale, sample_cnt)
            if lr0.shape[0] == 0:
                continue
            for k in range(lr_seqs.shape[0]):
                out.append({"LR_0": lr0[-1], "LR_1": lr_seqs[k], "depth": depth})
    return out
