"""Serving: batched SR inference from a checkpoint.

``SRPredictor`` loads a checkpoint (a port ``.pth`` bundle, a JAX ``.ckpt``
or a reference ``.pth``: ``runtime/checkpoint.py::load_checkpoint_file``,
the pickled reference forms only with ``allow_pickle``), folds it into the fused
serving graph (``models/inference.py``; ``fused=False`` serves the layer-by-
layer eval forward instead), keeps the weights on the device, and streams
(N, C, 4, 4) readings to (N, 1, 4s, 4s) contact-pressure maps.  Requests are
padded up to a fixed set of batch buckets, and larger ones are split into
chunks of the largest bucket, so the device only ever sees those shapes.
Compute runs in bf16 by default; the output is f32.  ``model_arch`` picks
the network, as the training config's key does: ``TactileSR`` (STSR/MTSR,
the default) or ``TactileSRCNN`` (single-frame; ``pattern_layers`` is then
its MSRB count).  ``branch_mode`` picks the MTSR branch layout
(``models/inference.py``, rewrite 4); ``auto`` serves ``grouped`` for S>1,
which the H100 found no slower than ``per_seq`` at every default bucket
(PERF.md section 6, PR 11), so one layout is folded per predictor.
:func:`export_program` writes the forward served at one bucket as a
``torch.export`` program with the weights in it.  While a torch profiler
runs, ``predict`` records its phases as spans (``runtime/tracing.py``):
``serving.predict`` around the request, and under it, for each chunk,
``serving.prepare`` (bucket, pad, split), ``serving.h2d``,
``serving.launch`` and ``serving.fetch``, then ``serving.assemble``.

``mesh`` (an in-process ``parallel.Mesh`` over devices, or ``--data-parallel
auto|N|off`` over the local CUDA devices) serves data-parallel, as JAX
shards a batch over its mesh: the buckets round up to multiples of the data
axis, the folded weights are replicated once on each device, every padded
bucket splits into equal contiguous shards, each enqueued on its device,
and the shards' outputs are concatenated.  A hot swap replaces every
replica from one checkpoint.

    python -m tactilesr_torch.serving --checkpoint x.pth --input frames.npz --output sr.npz
    python -m tactilesr_torch.serving --checkpoint x.pth --input test.npz --evaluate
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from .models.inference import (
    BRANCH_MODES,
    fold_inference_params,
    fold_inference_params_cnn,
    resolve_branch_mode,
    tactile_sr_cnn_infer,
    tactile_sr_infer,
)
from .models.tactile_sr import TactileSR, TactileSRCNN
from .parallel.mesh import local_devices, resolve_mesh
from .runtime.checkpoint import load_checkpoint_file
from .runtime import tracing
from .runtime.device import resolve_device

__all__ = ["SRPredictor", "DEFAULT_BUCKETS", "MODEL_ARCHS", "export_program"]

logger = logging.getLogger("tactilesr_torch")

DEFAULT_BUCKETS = (1, 8, 64, 256, 1024)
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODEL_ARCHS = ("TactileSR", "TactileSRCNN")

def _spec(weights) -> dict:
    """{name: (shape, dtype)}: the fingerprint a hot-swapped checkpoint must
    match."""
    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    return {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}


class SRPredictor:
    """TactileSR or TactileSRCNN inference with batch bucketing on one
    device, or on each device of ``mesh`` (which then replaces ``device``)."""

    def __init__(
        self,
        checkpoint_path: str,
        scale_factor: int = 10,
        seqs_cnt: int = 1,
        axis_cnt: int = 3,
        pattern_layers: int = 6,
        force_layers: int = 1,
        compute_dtype: str = "bfloat16",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        fused: bool = True,
        device="cuda",
        model_arch: str = "TactileSR",
        branch_mode: str = "auto",
        allow_pickle: bool = False,
        mesh=None,
    ):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {compute_dtype!r}")
        if model_arch not in MODEL_ARCHS:
            raise ValueError(f"model_arch must be one of {MODEL_ARCHS}, got {model_arch!r}")
        if model_arch == "TactileSRCNN" and seqs_cnt != 1:
            raise ValueError(f"TactileSRCNN is single-frame; got seqs_cnt={seqs_cnt}")
        self.model_arch = model_arch
        self.mesh = mesh
        if mesh is not None:
            if not mesh.devices:
                raise ValueError("serving takes a mesh over this process's devices "
                                 "(parallel.make_mesh([...]))")
            self.devices = tuple(resolve_device(d) for d in mesh.devices)
            adj = tuple(sorted({-(-b // mesh.size) * mesh.size for b in buckets}))
            if adj != tuple(sorted(buckets)):
                logger.info("buckets %s rounded to data-axis multiples: %s",
                            tuple(sorted(buckets)), adj)
            buckets = adj
        else:
            self.devices = (resolve_device(device),)
        self.device = self.devices[0]
        self.dtype = COMPUTE_DTYPES[compute_dtype]
        self.in_channels = seqs_cnt * axis_cnt
        self.buckets = tuple(sorted(buckets))
        self.fused = fused
        self._arch = dict(scale_factor=scale_factor, seqs_cnt=seqs_cnt, axis_cnt=axis_cnt)
        self._pattern_layers = pattern_layers
        self._force_layers = force_layers
        self.branch_mode = resolve_branch_mode(branch_mode, seqs_cnt)
        self.allow_pickle = allow_pickle
        self._replicas = None
        self._load_weights(checkpoint_path)
        logger.info("SRPredictor ready: %s (buckets %s, fused=%s, branch_mode %s, %s on %s)",
                    checkpoint_path, self.buckets, fused, self.branch_mode, compute_dtype,
                    ", ".join(str(d) for d in self.devices))

    @property
    def _weights(self):
        """The serving state on the first device."""
        return self._replicas[0]

    def _build(self, state_dict: dict, device: torch.device):
        """The serving state for one checkpoint: folded tensors (fused) or
        an eval-mode model of ``model_arch`` (unfused), on ``device``."""
        cnn = self.model_arch == "TactileSRCNN"
        if self.fused and cnn:
            return fold_inference_params_cnn(state_dict, msrb_cnt=self._pattern_layers,
                                             dtype=self.dtype, device=device)
        if self.fused:
            return fold_inference_params(
                state_dict, seqs_cnt=self._arch["seqs_cnt"],
                pattern_layers=self._pattern_layers, force_layers=self._force_layers,
                dtype=self.dtype, device=device, branch_mode=self.branch_mode,
            )
        if cnn:
            model = TactileSRCNN(scale_factor=self._arch["scale_factor"], msrb_cnt=self._pattern_layers,
                                 axis_cnt=self._arch["axis_cnt"], dtype=self.dtype)
        else:
            model = TactileSR(
                pattern_feature_extra_layer_cnt=self._pattern_layers,
                force_feature_extra_layer_cnt=self._force_layers, dtype=self.dtype, **self._arch,
            )
        try:
            model.load_state_dict(state_dict, strict=True)
        except RuntimeError as e:  # missing, unexpected or mis-shaped keys
            raise KeyError(str(e)) from e
        return model.to(device).eval().requires_grad_(False)

    def _load_weights(self, checkpoint_path: str) -> None:
        """Load (or hot-swap) weights, one replica a device from one read of
        the checkpoint.  All work happens on locals and the replicas are
        rebound only after every check passed, so a refused checkpoint
        leaves the previous weights serving."""
        state_dict = load_checkpoint_file(checkpoint_path, allow_pickle=self.allow_pickle)["model"]
        try:
            new = tuple(self._build(state_dict, d) for d in self.devices)
        except KeyError as e:
            raise KeyError(
                f"checkpoint {checkpoint_path!r} does not fit the serving architecture "
                f"(model_arch={self.model_arch}, seqs_cnt={self._arch['seqs_cnt']}, "
                f"pattern_layers={self._pattern_layers}, force_layers={self._force_layers}): {e}"
            ) from e
        spec = _spec(new[0])
        if self._replicas is not None and spec != self._spec:
            raise ValueError(
                f"checkpoint {checkpoint_path!r} does not match the serving architecture "
                "(different parameter shapes); previous weights keep serving"
            )
        self._spec = spec
        self._replicas = new  # one rebind: predict() snapshots it per request

    def reload_checkpoint(self, checkpoint_path: str) -> None:
        """Hot-swap weights on a live predictor; a mismatched checkpoint
        raises and the previous weights keep serving."""
        self._load_weights(checkpoint_path)
        logger.info("SRPredictor weights hot-swapped from %s", checkpoint_path)

    @torch.no_grad()
    def _forward(self, w, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.model_arch == "TactileSRCNN":
            return tactile_sr_cnn_infer(w, x, scale_factor=self._arch["scale_factor"],
                                        msrb_cnt=self._pattern_layers)
        if self.fused:
            return tactile_sr_infer(
                w, x, pattern_layers=self._pattern_layers, force_layers=self._force_layers,
                branch_mode=self.branch_mode, **self._arch,
            )
        return w(x)

    def warmup(self) -> None:
        """Run every bucket once on every replica (cuDNN picks its algorithms
        on first use)."""
        for w, dev in zip(self._replicas, self.devices):
            for b in self.buckets:
                self._forward(w, torch.zeros((b // len(self.devices), self.in_channels, 4, 4),
                                             device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, lr: np.ndarray) -> np.ndarray:
        """(N, C, 4, 4) raw-scaled readings -> (N, 1, 4s, 4s) SR maps (f32)."""
        lr = np.asarray(lr, np.float32)
        if lr.ndim != 4 or lr.shape[1:] != (self.in_channels, 4, 4):
            raise ValueError(f"expected (N, {self.in_channels}, 4, 4), got {lr.shape}")
        n = lr.shape[0]
        replicas = self._replicas  # one snapshot for the whole request
        outs = []
        i = 0
        with tracing.span("serving.predict", frames=n, chunks=-(-n // self.buckets[-1])):
            while i < n:
                with tracing.span("serving.prepare"):
                    b = self._bucket(n - i)
                    chunk = lr[i:i + b]
                    take = chunk.shape[0]
                    if take < b:
                        chunk = np.concatenate([chunk, np.zeros((b - take,) + chunk.shape[1:], np.float32)])
                    # one equal contiguous shard a device, all enqueued before any is read
                    shards = np.split(np.ascontiguousarray(chunk), len(replicas))
                with tracing.span("serving.h2d"):
                    xs = [torch.from_numpy(x).to(dev) for x, dev in zip(shards, self.devices)]
                with tracing.span("serving.launch"):
                    ys = [self._forward(w, x) for w, x in zip(replicas, xs)]
                with tracing.span("serving.fetch"):
                    outs.append(torch.cat([y.cpu() for y in ys])[:take].numpy())
                i += take
            if not outs:
                hw = 4 * self._arch["scale_factor"]
                return np.zeros((0, 1, hw, hw), np.float32)
            with tracing.span("serving.assemble"):
                return np.concatenate(outs)


class _ServedForward(torch.nn.Module):
    """The forward ``pred`` serves, as a module that holds the eval model or
    the folded weights as parameters or buffers, so that a ``torch.export``
    program of it owns them.  The resize matrix, read from the per-device
    cache, is lifted into the program as a constant."""

    def __init__(self, pred: "SRPredictor"):
        super().__init__()
        self._pred = pred
        w = pred._weights
        if isinstance(w, torch.nn.Module):
            self.model, self._keys = w, None
        else:
            self._keys = list(w)
            for i, k in enumerate(self._keys):
                self.register_buffer(f"w{i}", w[k])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._keys is None:
            return self._pred._forward(self.model, x)
        return self._pred._forward({k: getattr(self, f"w{i}") for i, k in enumerate(self._keys)}, x)


def export_program(
    checkpoint_path: str,
    out_path: str,
    batch: int = 256,
    scale_factor: int = 10,
    seqs_cnt: int = 1,
    pattern_layers: int = 6,
    force_layers: int = 1,
    compute_dtype: str = "bfloat16",
    fused: bool = True,
    model_arch: str = "TactileSR",
    branch_mode: str = "auto",
    device="cuda",
) -> str:
    """Save the forward ``SRPredictor`` would serve at bucket ``batch``
    (fused, or ``fused=False`` for the eval model; ``model_arch`` and
    ``branch_mode`` honoured) as a ``torch.export`` program with the weights
    baked in: ``torch.export.load(out_path).module()(x)`` runs it on a
    (batch, C, 4, 4) f32 ``x`` on ``device`` with nothing of this package."""
    pred = SRPredictor(checkpoint_path, scale_factor=scale_factor, seqs_cnt=seqs_cnt,
                       pattern_layers=pattern_layers, force_layers=force_layers,
                       compute_dtype=compute_dtype, buckets=(batch,), fused=fused, device=device,
                       model_arch=model_arch, branch_mode=branch_mode)
    x = torch.zeros((batch, pred.in_channels, 4, 4), device=pred.device)
    with torch.no_grad():  # the forward's own no_grad then records nothing
        program = torch.export.export(_ServedForward(pred), (x,), strict=False)
    torch.export.save(program, out_path)
    logger.info("exported the bucket-%d forward (%s) -> %s", batch, pred.branch_mode, out_path)
    return out_path


def _cli(argv=None):
    import argparse
    import json
    import time

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.serving",
                                description="Batched SR inference from a port checkpoint")
    p.add_argument("--checkpoint", required=True, help="port .pth bundle, JAX .ckpt or reference .pth")
    p.add_argument("--allow-pickle", action="store_true",
                   help="unpickle a reference .pth that holds Python objects (only for a trusted file)")
    p.add_argument("--input", required=True, help=".npz with an 'LR' array")
    p.add_argument("--output", default=None, help=".npz to write 'SR' maps to")
    p.add_argument("--seqs-cnt", type=int, default=1)
    p.add_argument("--scale-factor", type=int, default=10)
    p.add_argument("--pattern-layers", type=int, default=6)
    p.add_argument("--force-layers", type=int, default=1)
    p.add_argument("--compute-dtype", default="bfloat16", choices=sorted(COMPUTE_DTYPES))
    p.add_argument("--model-arch", default="TactileSR", choices=MODEL_ARCHS,
                   help="same knob as the training config's model_arch")
    p.add_argument("--no-fused", action="store_true",
                   help="serve the layer-by-layer eval forward instead of the fused graph")
    p.add_argument("--branch-mode", default="auto", choices=("auto",) + BRANCH_MODES,
                   help="MTSR branch layout (models/inference.py rewrite 4); auto: grouped for S>1")
    p.add_argument("--evaluate", action="store_true",
                   help="if the input .npz has an 'HR' array, report PSNR/SSIM against it")
    p.add_argument("--hr-scale-num", type=float, default=10.0)
    p.add_argument("--max-value", type=float, default=250.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-parallel", default="off",
                   help="shard serving batches over this process's devices: off|auto|N "
                        "(the training configs' knob)")
    args = p.parse_args(argv)

    with np.load(args.input) as z:
        lr = z["LR"]
        hr = z["HR"] if args.evaluate and "HR" in z else None
    pred = SRPredictor(
        args.checkpoint, scale_factor=args.scale_factor, seqs_cnt=args.seqs_cnt,
        pattern_layers=args.pattern_layers, force_layers=args.force_layers,
        compute_dtype=args.compute_dtype, fused=not args.no_fused, device=args.device,
        model_arch=args.model_arch, branch_mode=args.branch_mode, allow_pickle=args.allow_pickle,
        mesh=resolve_mesh(args.data_parallel, devices=local_devices(args.device)),
    )
    pred.warmup()
    t0 = time.perf_counter()
    sr = pred.predict(lr)  # returns host arrays: the device work is done
    dt = time.perf_counter() - t0
    report = {
        "frames": int(lr.shape[0]),
        "seconds": dt,
        "frames_per_sec": lr.shape[0] / dt if dt > 0 else None,
        "output_shape": list(sr.shape),
        "device": ", ".join(str(d) for d in pred.devices),
        "branch_mode": pred.branch_mode,
    }
    if hr is not None:
        from .metrics import batched_psnr, batched_ssim
        from .tasks.sr_task import prepare_sr_labels

        label = torch.from_numpy(prepare_sr_labels(
            hr, {"scale_factor": args.scale_factor, "HR_scale_num": args.hr_scale_num}))[:, 0]
        out = torch.from_numpy(sr)[:, 0]
        report["psnr_db"] = float(batched_psnr(out, label, args.max_value).mean())
        report["ssim"] = float(batched_ssim(out, label).mean())
    print(json.dumps(report))
    if args.output:
        np.savez(args.output, SR=sr)
        logger.info("wrote %s", args.output)


if __name__ == "__main__":
    _cli()
