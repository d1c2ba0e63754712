"""Offline SR-dataset generation: a trained tPSFNet manufactures the HR
labels that the SR networks train on.

- ``generate_single_srdataset`` follows the reference generator
  (data/SRdataset/depth2tactile.py:62-160): fixed train/val/test tap-index
  splits over the 9x9 grid, one record per sample ``{LR (3,4,4) already
  /scale_num, depth (1,100,100), HR (1,100,100), LR_degrade (1,4,4),
  alphaBeta (3,)}``.
- ``generate_seqs_srdataset`` follows the reference's
  data/SeqsDataset/seqsDepth2Tactile.py:20-107: for each contact,
  translation and press depth, 7 rotation frames (0-30 degrees) make a
  (21,4,4) LR in deepest-first order, the 30-degree frame sweeping the
  press sequence and rotations 0-25 degrees taking the deepest press; the
  HR comes from the 30-degree frame; splits go by translation index (0
  test, 1 validation, the rest train).

Each split runs as batched tPSF physics on the device (the CUDA kernel on
a GPU), in fixed-size zero-padded chunks, and is saved as a stacked
``.npz`` (plus the reference's object ``.npy`` on request).  As in the JAX
package, ``--physics-precision`` picks the kernel's products (``highest``
f32, ``default`` one bf16 pass, ``high`` three) and ``--use-pallas false``
runs the plain f32 physics on the chosen device instead of the kernel.

    python -m tactilesr_torch.data.generate synthetic --out-dir raw/
    python -m tactilesr_torch.data.generate single --tpsf-checkpoint tpsf.pth \\
        --raw-dir raw/ --out-dir sr/ --sample-cnt 4
    python -m tactilesr_torch.data.generate seqs --tpsf-checkpoint tpsf.pth \\
        --raw-dir raw/ --out-dir seqs/ --sample-cnt 4 --n-contacts 3
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.tpsf_net import TPSFNet
from ..ops.psf import PHYSICS_PRECISIONS, resolve_use_kernel
from ..runtime.checkpoint import load_checkpoint_file
from ..runtime.device import resolve_device
from .datasets import TPSFNetDataset

__all__ = ["tpsf_apply_batched", "generate_single_srdataset", "generate_seqs_srdataset",
           "SINGLE_SPLITS", "load_tpsf"]

logger = logging.getLogger("tactilesr_torch")

# the reference's tap-index splits over the 9-translation x 9-rotation grid
SINGLE_SPLITS = {
    "test": [0, 6, 7, 8],
    "validation": [9 + i for i in (0, 6, 7, 8)],
    "train": [9 * k + i for k in range(2, 9) for i in (0, 6, 7, 8)],
}


def load_tpsf(checkpoint_path: str, gama: float = 1.4, physics_precision: str = "highest",
              device="cuda", use_pallas="auto") -> TPSFNet:
    """A TPSFNet in eval mode on ``device`` from a port ``.pth`` bundle, its
    physics at ``physics_precision`` through the kernel (``use_pallas``
    auto or true) or the plain f32 physics (false).  Typos raise."""
    dev = resolve_device(device)
    model = TPSFNet(gama=gama, use_kernel=resolve_use_kernel(use_pallas),
                    physics_precision=physics_precision)
    model.load_state_dict(load_checkpoint_file(checkpoint_path)["model"], strict=True)
    return model.to(dev).eval()


@torch.no_grad()
def tpsf_apply_batched(model: TPSFNet, lr: np.ndarray, depth: np.ndarray,
                       scale_num: float = 100.0, batch: int = 256) -> Dict[str, np.ndarray]:
    """Run the physics over a whole split in fixed chunks of ``batch``
    (the last one zero-padded, so every launch has one shape).

    Returns stacked arrays: LR (scaled), depth (1,100,100), HR, LR_degrade,
    alphaBeta."""
    dev = next(model.parameters()).device
    n = lr.shape[0]
    if n == 0:
        empty = {"HR": (1, 100, 100), "LR_degrade": (1, 4, 4), "alphaBeta": (3,)}
        out = {k: np.zeros((0,) + s, np.float32) for k, s in empty.items()}
        out["LR"] = lr.astype(np.float32)
        out["depth"] = depth[:, None].astype(np.float32)
        return out
    pad = (-n) % batch
    lr_p = np.concatenate([lr, np.zeros((pad,) + lr.shape[1:], lr.dtype)]) if pad else lr
    d_p = np.concatenate([depth, np.zeros((pad,) + depth.shape[1:], depth.dtype)]) if pad else depth
    outs = {"HR": [], "LR_degrade": [], "alphaBeta": []}
    for i in range(0, n + pad, batch):
        lr_b = torch.from_numpy(np.ascontiguousarray(lr_p[i:i + batch], np.float32)).to(dev)
        d_b = torch.from_numpy(np.ascontiguousarray(d_p[i:i + batch], np.float32)).to(dev)
        hr, deg, _psf, ab = model(lr_b / scale_num, d_b[:, None], return_psf=False)
        outs["HR"].append(hr.cpu().numpy())
        outs["LR_degrade"].append(deg.cpu().numpy())
        outs["alphaBeta"].append(ab[:, 0].cpu().numpy())
    result = {k: np.concatenate(v)[:n] for k, v in outs.items()}
    result["LR"] = (lr.astype(np.float32) / scale_num)[:n]
    result["depth"] = depth[:, None].astype(np.float32)[:n]
    return result


@contextlib.contextmanager
def _timed(timings: Optional[Dict[str, float]], key: str):
    """Adds the block's host seconds to ``timings[key]`` (when given)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _save_split(out_dir: str, name: str, arrays: Dict[str, np.ndarray], legacy: bool) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, name + ".npz"), **arrays)
    if legacy:
        # reference schema: an array of singleton object arrays, so that
        # ``dataset[idx].item()['LR']`` works with the reference's loader
        n = arrays["LR"].shape[0]
        rows = np.empty(n, dtype=object)
        for i in range(n):
            row = np.empty(1, dtype=object)
            row[0] = {k: v[i] for k, v in arrays.items()}
            rows[i] = row
        np.save(os.path.join(out_dir, name + ".npy"), rows, allow_pickle=True)
    logger.info("saved %s: %d samples", name, arrays["LR"].shape[0])


def generate_single_srdataset(
    tpsf_checkpoint: str,
    raw_dataset_dir: str,
    out_dir: str,
    sample_cnt: int = 16,
    scale_num: float = 100.0,
    gama: float = 1.4,
    legacy_npy: bool = False,
    splits: Optional[Dict[str, Sequence[int]]] = None,
    physics_precision: str = "highest",
    batch: int = 256,
    device="cuda",
    use_pallas="auto",
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, str]:
    """Single-frame SRdataset: {LR, depth, HR, LR_degrade, alphaBeta} per split.

    ``timings``, when given, gains the host seconds of loading the model
    ("load"), the raw preprocessing ("preprocess"), the physics with its
    copies to and from the device ("physics") and writing the splits
    ("save")."""
    with _timed(timings, "load"):
        model = load_tpsf(tpsf_checkpoint, gama, physics_precision, device, use_pallas)
    paths = {}
    for split, idx in (splits or SINGLE_SPLITS).items():
        with _timed(timings, "preprocess"):
            ds = TPSFNetDataset(raw_dataset_dir, sample_cnt=sample_cnt,
                                is_sample_idx=list(idx), is_aug_data=False)
            lr, depth = ds.stacked()
        with _timed(timings, "physics"):
            arrays = tpsf_apply_batched(model, lr, depth, scale_num, batch)
        name = f"SRdataset_{split}"
        with _timed(timings, "save"):
            _save_split(out_dir, name, arrays, legacy_npy)
        paths[split] = os.path.join(out_dir, name + ".npz")
    return paths


def generate_seqs_srdataset(
    tpsf_checkpoint: str,
    raw_dataset_dir: str,
    out_dir: str,
    sample_cnt: int = 16,
    scale_num: float = 100.0,
    gama: float = 1.4,
    n_contacts: int = 18,
    n_translations: int = 9,
    legacy_npy: bool = False,
    suffix: str = "_32",
    physics_precision: str = "highest",
    batch: int = 256,
    device="cuda",
    use_pallas="auto",
) -> Dict[str, str]:
    """Multi-frame SeqsDataset: {LR (21,4,4), depth (1,100,100), HR} per split."""
    model = load_tpsf(tpsf_checkpoint, gama, physics_precision, device, use_pallas)
    ds = TPSFNetDataset(raw_dataset_dir, sample_cnt=sample_cnt,
                        is_sample_idx=list(range(0, n_translations * 9)), is_aug_data=False)
    lr_all, depth_all = ds.stacked()
    taps_per_contact = sample_cnt * n_translations * 9

    def flat_index(contact, trans, rot, seq):
        return seq + sample_cnt * (rot + trans * 9) + taps_per_contact * contact

    collected = {"train": [], "validation": [], "test": []}
    split_of_trans = {0: "test", 1: "validation"}
    n_avail = lr_all.shape[0]
    for contact in range(n_contacts):
        for trans in range(n_translations):
            for seq in range(sample_cnt):
                # rotations 0, 5, ..., 25 degrees take the deepest press frame;
                # the 30-degree frame sweeps the press sequence
                idxs = [flat_index(contact, trans, rot, sample_cnt - 1) for rot in range(6)]
                idx30 = flat_index(contact, trans, 6, seq)
                if max(idxs + [idx30]) >= n_avail:
                    continue
                collected[split_of_trans.get(trans, "train")].append((idx30, idxs[::-1]))

    paths: Dict[str, str] = {}
    for split, rows in collected.items():
        if not rows:
            logger.warning("seqs split '%s' is empty", split)
            continue
        idx30 = np.asarray([r[0] for r in rows])
        frames = np.asarray([[r[0]] + r[1] for r in rows])  # (N, 7), deepest-first
        lr_cat = lr_all[frames].reshape(len(rows), -1, 4, 4).astype(np.float32) / scale_num
        phys = tpsf_apply_batched(model, lr_all[idx30], depth_all[idx30], scale_num, batch)
        arrays = {"LR": lr_cat, "depth": phys["depth"], "HR": phys["HR"]}
        name = f"SRdataset_{split}{suffix}"
        _save_split(out_dir, name, arrays, legacy_npy)
        paths[split] = os.path.join(out_dir, name + ".npz")
    return paths


def _cli(argv=None):
    import argparse

    from .synthetic import generate_rotate_dataset

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(
        prog="python -m tactilesr_torch.data.generate",
        description="Dataset generation: synthetic raw blobs, SRdataset, SeqsDataset",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("synthetic", help="fabricate raw rotateDataset blobs")
    ps.add_argument("--out-dir", required=True)
    ps.add_argument("--names", nargs="+", default=["C", "I", "P"])
    ps.add_argument("--taps-per-blob", type=int, default=81)
    ps.add_argument("--seqs", type=int, default=64)
    ps.add_argument("--seed", type=int, default=0)

    for name in ("single", "seqs"):
        pg = sub.add_parser(name, help=f"generate the {name}-frame SR dataset")
        pg.add_argument("--tpsf-checkpoint", required=True, help="port .pth bundle")
        pg.add_argument("--raw-dir", required=True)
        pg.add_argument("--out-dir", required=True)
        pg.add_argument("--sample-cnt", type=int, default=16)
        pg.add_argument("--scale-num", type=float, default=100.0)
        pg.add_argument("--gama", type=float, default=1.4)
        pg.add_argument("--legacy-npy", action="store_true")
        pg.add_argument("--use-pallas", default="auto",
                        help="the physics kernel: auto|true (the kernel on a GPU, its plain "
                        "version on the CPU) or false (the plain f32 physics, no kernel)")
        pg.add_argument("--physics-precision", default="highest", choices=PHYSICS_PRECISIONS,
                        help="the kernel's products: highest (f32), default (one bf16 "
                        "tensor-core pass, f32 sums) or high (three bf16 passes)")
        pg.add_argument("--batch", type=int, default=256, help="physics batch per launch")
        pg.add_argument("--device", default="cuda")
        if name == "seqs":
            pg.add_argument("--n-contacts", type=int, default=18)
            pg.add_argument("--n-translations", type=int, default=9)

    args = p.parse_args(argv)
    if args.cmd == "synthetic":
        paths = generate_rotate_dataset(args.out_dir, names=tuple(args.names),
                                        taps_per_blob=args.taps_per_blob, seed=args.seed,
                                        seqs=args.seqs)
        print("\n".join(paths))
        return
    common = dict(sample_cnt=args.sample_cnt, scale_num=args.scale_num, gama=args.gama,
                  legacy_npy=args.legacy_npy, physics_precision=args.physics_precision,
                  batch=args.batch, device=args.device, use_pallas=args.use_pallas)
    if args.cmd == "single":
        paths = generate_single_srdataset(args.tpsf_checkpoint, args.raw_dir, args.out_dir, **common)
    else:
        paths = generate_seqs_srdataset(args.tpsf_checkpoint, args.raw_dir, args.out_dir,
                                        n_contacts=args.n_contacts,
                                        n_translations=args.n_translations, **common)
    print("\n".join(f"{k}: {v}" for k, v in paths.items()))


if __name__ == "__main__":
    _cli()
