"""Synthetic raw-dataset fixtures (numpy only).

Fabricates ``.npy`` blobs with the raw rotateDataset schema ``{sample_idx,
depth (HxW), LRs (seqs, 48)}`` (reference utility/raw_data_process.py:
97-110): a shaped contact depth map plus a simulated press sequence whose
per-taxel forces ramp up to a peak and release.  The port's copy of
``tactilesr_tpu/data/synthetic.py``: the same seed writes the same bytes.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["make_tap_record", "write_raw_blob", "generate_rotate_dataset"]

_SHAPES = ("circle", "square", "triangle", "bar")


def _depth_map(shape_name, rng, px=100, center=None, angle_deg=0.0, radius=None):
    """A binary-ish contact silhouette with smooth borders."""
    y, x = np.mgrid[0:px, 0:px].astype(np.float32)
    if center is None:
        cx = px / 2 + rng.uniform(-8, 8)
        cy = px / 2 + rng.uniform(-8, 8)
    else:
        cx, cy = center
    r = radius if radius is not None else px * rng.uniform(0.15, 0.3)
    th = np.deg2rad(angle_deg)  # rotate the sampling frame by -angle
    xr = np.cos(th) * (x - cx) + np.sin(th) * (y - cy)
    yr = -np.sin(th) * (x - cx) + np.cos(th) * (y - cy)
    if shape_name == "circle":
        d = (xr**2 + yr**2) < r * r
    elif shape_name == "square":
        d = (np.abs(xr) < r) & (np.abs(yr) < r)
    elif shape_name == "triangle":
        d = (yr > -(r / 1.2)) & (np.abs(xr) < (yr + r) / 2)
    else:  # bar
        d = (np.abs(xr) < r / 3) & (np.abs(yr) < r * 1.4)
    depth = d.astype(np.float32)
    depth += 0.05 * rng.standard_normal((px, px)).astype(np.float32)
    return depth


def _press_sequence(depth, seqs, rng):
    """(seqs, 48) force frames: z grows with press depth under each taxel's
    contact area, x/y are small shear noise; the ramp peaks at 85% of the
    sequence, then a short release tail."""
    px = depth.shape[0]
    cell = px // 4
    contact = (depth > 0.5).astype(np.float32)
    taxel_area = contact.reshape(4, cell, 4, cell).mean(axis=(1, 3))  # (4,4)

    peak_t = int(seqs * 0.85)
    profile = np.zeros(seqs, np.float32)
    profile[: peak_t + 1] = np.linspace(0.02, 1.0, peak_t + 1)
    if seqs - peak_t - 1 > 0:
        profile[peak_t + 1:] = np.linspace(0.8, 0.1, seqs - peak_t - 1)

    frames = np.zeros((seqs, 16, 3), np.float32)
    # raw taxel units O(100-800), so /scale_num(=100) lands in O(1-8)
    base_force = rng.uniform(300.0, 800.0)
    for t in range(seqs):
        z = base_force * profile[t] * (taxel_area + 0.02)
        z = z * (1 + 0.05 * rng.standard_normal((4, 4)))
        xy = 0.1 * profile[t] * rng.standard_normal((4, 4, 2))
        # undo the sensor's vertical flip so extraction re-applies it
        frames[t, :, 2] = z[::-1].reshape(16)
        frames[t, :, 0] = xy[::-1, :, 0].reshape(16)
        frames[t, :, 1] = xy[::-1, :, 1].reshape(16)
    return frames.reshape(seqs, 48)


def make_tap_record(sample_idx, rng, shape_name: Optional[str] = None, seqs=64, px=100,
                    center=None, angle_deg=0.0, radius=None) -> dict:
    shape_name = shape_name or _SHAPES[sample_idx % len(_SHAPES)]
    depth = _depth_map(shape_name, rng, px, center=center, angle_deg=angle_deg, radius=radius)
    return {"sample_idx": sample_idx, "depth": depth, "LRs": _press_sequence(depth, seqs, rng)}


def write_raw_blob(path: str, n_taps: int, seed: int = 0, shape_name: Optional[str] = None,
                   seqs: int = 64, px: int = 100, grid: bool = True) -> str:
    """Write one raw blob of ``n_taps`` tap records (object ``.npy``).

    ``grid=True`` follows the rotateDataset layout: one contact shape per
    blob, taps grouped 9 per translation, rotations 0, 5, ..., 40 degrees
    within a group.  ``grid=False`` gives independent taps.
    """
    rng = np.random.default_rng(seed)
    records = np.empty(n_taps, dtype=object)
    blob_shape = shape_name or _SHAPES[seed % len(_SHAPES)]
    radius = px * rng.uniform(0.18, 0.28)
    centers = {}
    for i in range(n_taps):
        if grid:
            trans, rot = i // 9, i % 9
            if trans not in centers:
                centers[trans] = (px / 2 + rng.uniform(-10, 10), px / 2 + rng.uniform(-10, 10))
            records[i] = make_tap_record(i, rng, blob_shape, seqs, px, center=centers[trans],
                                         angle_deg=5.0 * rot, radius=radius)
        else:
            records[i] = make_tap_record(i, rng, shape_name, seqs, px)
    # each record is a 0-d object ndarray wrapping the dict, as the
    # reference's loader calls ``.item()`` on every element
    for i in range(n_taps):
        records[i] = np.array(records[i], dtype=object)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, records, allow_pickle=True)
    return path


def generate_rotate_dataset(dataset_dir: str, names: Sequence[str] = ("C", "I", "P"),
                            taps_per_blob: int = 81, seed: int = 0, seqs: int = 64) -> list:
    """A rotateDataset directory: one blob per contact shape, 81 taps each
    (9 translations x 9 rotations) by default."""
    return [
        write_raw_blob(os.path.join(dataset_dir, f"{name}.npy"), n_taps=taps_per_blob,
                       seed=seed + k, seqs=seqs)
        for k, name in enumerate(names)
    ]
