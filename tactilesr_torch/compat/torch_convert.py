"""A port or reference ``.pth`` -> the JAX package's ``.ckpt`` bundle (the
port of ``tactilesr_tpu/compat/torch_convert.py``, in plain msgpack).

The inverse of ``compat/from_jax.py``, kept here so the port needs nothing
of the JAX package: conv weights torch (O,I,kh,kw) -> flax (kh,kw,I,O),
Dense weights transposed, BatchNorm weight/bias -> scale/bias params and
running_mean/var -> batch_stats; ``num_batches_tracked`` has no JAX
counterpart and is dropped.  The reference's key layout (its model
definitions, ``model/tactileSR_model.py:18-153`` and ``model/tPSFNet.py:26-36``):

- TactileSR: ``inputLayer_pattern_list.{s}.{1,2,4,5}``,
  ``inputContact_layer.{0,1}``, ``patternFeatureExtra_layer.{i}.conv_*``,
  ``forceFeatureExtra_layer.{i}``, ``output_layer.{0,2}``,
  ``input_layer_force.1``;
- TactileSRCNN: ``input_zyx.{0,1,3,4,6,7}``, ``msrb_layer.{i}``, ``output.0``;
- tPSFNet: ``MLP_layer.{1,3,5,7}``.

Every key of the state_dict must be read by the declared architecture: a
converter that skipped trained modules would write a truncated bundle that
looks valid, so leftovers raise.  The written bundle has the JAX
converter's keys, so ``tactilesr_tpu.runtime.checkpoint.load_checkpoint_file``
and its trainers read it.

    python -m tactilesr_torch.compat.torch_convert model.pth model.ckpt \\
        [--arch tactileSR] [--seqs-cnt 1] [--pattern-layers 6] [--force-layers 1]
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ..runtime.checkpoint import load_checkpoint_file, write_ckpt

__all__ = [
    "convert_checkpoint_file",
    "convert_tactile_sr",
    "convert_tactile_srcnn",
    "convert_tpsf_net",
]

logger = logging.getLogger("tactilesr_torch")


def _np(t):
    """A copy of ``t`` on the host: numpy, or a torch tensor for bf16
    (numpy has no bf16; ``write_ckpt`` writes it as flax does)."""
    t = t.detach().cpu()
    return t.clone() if t.dtype == torch.bfloat16 else np.array(t.numpy(), copy=True)


def _take_conv(sd: dict, prefix: str, bias: bool) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"].permute(2, 3, 1, 0))}  # OIHW -> HWIO
    if bias:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return {"conv": out}


def _take_bn(sd: dict, prefix: str) -> Tuple[dict, dict]:
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _msrb(sd: dict, prefix: str) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for name in ("conv_3_1", "conv_5_1", "conv_3_2", "conv_5_2"):
        params[name] = _take_conv(sd, f"{prefix}.{name}.0", bias=True)
        params[f"{name}_bn"], stats[f"{name}_bn"] = _take_bn(sd, f"{prefix}.{name}.1")
    params["confusion"] = _take_conv(sd, f"{prefix}.confusion", bias=True)
    return params, stats


def convert_tactile_sr(sd: dict, seqs_cnt: int = 1, pattern_layers: int = 6,
                       force_layers: int = 1) -> Dict[str, dict]:
    """TactileSR state_dict -> JAX ``{'params', 'batch_stats'}``."""
    params: dict = {}
    stats: dict = {}
    for s in range(seqs_cnt):
        base = f"inputLayer_pattern_list.{s}"
        for idx, (conv_i, bn_i) in enumerate([(1, 2), (4, 5)]):
            name = f"inputLayer_pattern_{s}_conv{idx}"
            params[name] = _take_conv(sd, f"{base}.{conv_i}", bias=False)
            params[f"{name}_bn"], stats[f"{name}_bn"] = _take_bn(sd, f"{base}.{bn_i}")

    params["inputContact_layer"] = _take_conv(sd, "inputContact_layer.0", bias=False)
    params["inputContact_layer_bn"], stats["inputContact_layer_bn"] = _take_bn(
        sd, "inputContact_layer.1")

    for i in range(pattern_layers):
        name = f"patternFeatureExtra_layer_{i}"
        params[name], stats[name] = _msrb(sd, f"patternFeatureExtra_layer.{i}")

    params["input_layer_force"] = _take_conv(sd, "input_layer_force.1", bias=False)
    for i in range(force_layers):
        prefix = f"forceFeatureExtra_layer.{i}"
        params[f"forceFeatureExtra_layer_{i}"] = {
            "conv1": _take_conv(sd, f"{prefix}.conv1", bias=True),
            "conv2": _take_conv(sd, f"{prefix}.conv2", bias=True),
        }

    params["output_conv0"] = _take_conv(sd, "output_layer.0", bias=False)
    params["output_conv1"] = _take_conv(sd, "output_layer.2", bias=False)
    return {"params": params, "batch_stats": stats}


def convert_tactile_srcnn(sd: dict, msrb_cnt: int = 6) -> Dict[str, dict]:
    """TactileSRCNN state_dict -> JAX ``{'params', 'batch_stats'}``."""
    params: dict = {}
    stats: dict = {}
    for idx, (conv_i, bn_i) in enumerate([(0, 1), (3, 4), (6, 7)]):
        params[f"input_zyx_conv{idx}"] = _take_conv(sd, f"input_zyx.{conv_i}", bias=False)
        params[f"input_zyx_bn{idx}"], stats[f"input_zyx_bn{idx}"] = _take_bn(
            sd, f"input_zyx.{bn_i}")
    for i in range(msrb_cnt):
        params[f"msrb_layer_{i}"], stats[f"msrb_layer_{i}"] = _msrb(sd, f"msrb_layer.{i}")
    params["output_conv"] = _take_conv(sd, "output.0", bias=False)
    return {"params": params, "batch_stats": stats}


def convert_tpsf_net(sd: dict) -> Dict[str, dict]:
    """tPSFNet state_dict -> JAX ``{'params', 'batch_stats': {}}``."""
    params = {
        f"mlp_{idx}": {"linear": {"kernel": _np(sd[f"MLP_layer.{torch_idx}.weight"].T),
                                  "bias": _np(sd[f"MLP_layer.{torch_idx}.bias"])}}
        for idx, torch_idx in enumerate([1, 3, 5, 7])
    }
    return {"params": params, "batch_stats": {}}


class _TrackedStateDict(dict):
    """A state_dict that records which keys a converter read."""

    def __init__(self, sd: dict):
        super().__init__(sd)
        self.used: set = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)


def _check_all_keys_consumed(tracked: _TrackedStateDict, arch: str) -> None:
    leftover = sorted(k for k in tracked
                      if k not in tracked.used and not k.endswith("num_batches_tracked"))
    if leftover:
        raise ValueError(
            f"{len(leftover)} checkpoint parameter(s) were not consumed by the declared "
            f"architecture ({arch}): {leftover[:8]}{' ...' if len(leftover) > 8 else ''} -- do "
            "seqs_cnt/pattern_layers/force_layers match the trained model?"
        )


_CONVERTERS = {
    "tactileSR": convert_tactile_sr,
    "tactileSRCNN": convert_tactile_srcnn,
    "tPSFNet": convert_tpsf_net,
}


def convert_checkpoint_file(pth_path: str, ckpt_path: str, arch: str = "tactileSR",
                            allow_pickle: bool = False, **arch_kwargs) -> str:
    """One-shot migration: a port or reference ``.pth`` (every form
    ``load_checkpoint_file`` reads; the pickled ones with ``allow_pickle``)
    -> a JAX ``.ckpt`` bundle.  Model weights only, as JAX's converter."""
    sd = _TrackedStateDict(load_checkpoint_file(pth_path, allow_pickle=allow_pickle)["model"])
    model = _CONVERTERS[arch](sd, **arch_kwargs)
    _check_all_keys_consumed(sd, arch)
    bundle = {
        "num_devices": 1,
        "num_processes": 1,
        "model": model,
        "metric_storage": {"window_size": 20, "smooth": {}, "latest_iter": {}, "history": {}},
        "converted_from": pth_path,
        "epoch": -1,
    }
    write_ckpt(ckpt_path, bundle)
    logger.info("converted %s (%s) -> %s", pth_path, arch, ckpt_path)
    return ckpt_path


def _cli(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m tactilesr_torch.compat.torch_convert",
        description="Convert a port or reference torch .pth checkpoint to a JAX .ckpt bundle",
    )
    p.add_argument("pth")
    p.add_argument("ckpt")
    p.add_argument("--arch", choices=sorted(_CONVERTERS), default="tactileSR")
    p.add_argument("--seqs-cnt", type=int, default=1)
    p.add_argument("--pattern-layers", type=int, default=6)
    p.add_argument("--force-layers", type=int, default=1)
    p.add_argument("--allow-pickle", action="store_true",
                   help="unpickle a .pth that holds Python objects (only for a trusted file)")
    args = p.parse_args(argv)
    kwargs = {}
    if args.arch == "tactileSR":
        kwargs = dict(seqs_cnt=args.seqs_cnt, pattern_layers=args.pattern_layers,
                      force_layers=args.force_layers)
    convert_checkpoint_file(args.pth, args.ckpt, arch=args.arch, allow_pickle=args.allow_pickle,
                            **kwargs)


if __name__ == "__main__":
    _cli()
