"""Weight bridge: the JAX package's ``{"params", "batch_stats"}`` trees (as
numpy arrays) -> the port's state_dicts, in the reference layout.

Conv kernels go HWIO -> OIHW, Dense kernels are transposed, BN
scale/bias/mean/var become weight/bias/running_mean/running_var (plus the
``num_batches_tracked`` buffer a strict load expects, 0: JAX does not
count).  Leaves may be numpy arrays or, for bf16 leaves read from a
``.ckpt``, torch tensors; every tensor comes out f32.  The mapping is the
same as ``tactilesr_tpu/compat/export_torch.py``'s, kept here so the port
needs nothing of the JAX package; the tests hold the two key sets equal.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["tactile_sr_state_dict", "tactile_srcnn_state_dict", "tpsf_net_state_dict"]


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32, copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _put_conv(sd: dict, prefix: str, entry: dict) -> None:
    sd[f"{prefix}.weight"] = _t(entry["conv"]["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in entry["conv"]:
        sd[f"{prefix}.bias"] = _t(entry["conv"]["bias"])


def _put_bn(sd: dict, prefix: str, bn_params: dict, bn_stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(bn_params["scale"])
    sd[f"{prefix}.bias"] = _t(bn_params["bias"])
    sd[f"{prefix}.running_mean"] = _t(bn_stats["mean"])
    sd[f"{prefix}.running_var"] = _t(bn_stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_msrb(sd: dict, prefix: str, p: dict, st: dict) -> None:
    for name in ("conv_3_1", "conv_5_1", "conv_3_2", "conv_5_2"):
        _put_conv(sd, f"{prefix}.{name}.0", p[name])
        _put_bn(sd, f"{prefix}.{name}.1", p[f"{name}_bn"], st[f"{name}_bn"])
    _put_conv(sd, f"{prefix}.confusion", p["confusion"])


def _count(params: dict, pattern: str) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for k in params if (m := rx.match(k))})


def tactile_sr_state_dict(variables: Dict[str, dict]) -> dict:
    """JAX TactileSR variables -> the port's ``TactileSR`` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for s in range(_count(params, r"inputLayer_pattern_(\d+)_conv0$")):
        base = f"inputLayer_pattern_list.{s}"
        for idx, (conv_i, bn_i) in enumerate([(1, 2), (4, 5)]):
            name = f"inputLayer_pattern_{s}_conv{idx}"
            _put_conv(sd, f"{base}.{conv_i}", params[name])
            _put_bn(sd, f"{base}.{bn_i}", params[f"{name}_bn"], stats[f"{name}_bn"])

    _put_conv(sd, "inputContact_layer.0", params["inputContact_layer"])
    _put_bn(sd, "inputContact_layer.1", params["inputContact_layer_bn"],
            stats["inputContact_layer_bn"])

    for i in range(_count(params, r"patternFeatureExtra_layer_(\d+)$")):
        _put_msrb(sd, f"patternFeatureExtra_layer.{i}", params[f"patternFeatureExtra_layer_{i}"],
                  stats[f"patternFeatureExtra_layer_{i}"])

    _put_conv(sd, "input_layer_force.1", params["input_layer_force"])
    for i in range(_count(params, r"forceFeatureExtra_layer_(\d+)$")):
        p = params[f"forceFeatureExtra_layer_{i}"]
        _put_conv(sd, f"forceFeatureExtra_layer.{i}.conv1", p["conv1"])
        _put_conv(sd, f"forceFeatureExtra_layer.{i}.conv2", p["conv2"])

    _put_conv(sd, "output_layer.0", params["output_conv0"])
    _put_conv(sd, "output_layer.2", params["output_conv1"])
    return sd


def tactile_srcnn_state_dict(variables: Dict[str, dict]) -> dict:
    """JAX TactileSRCNN variables -> the port's ``TactileSRCNN`` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i, (conv_i, bn_i) in enumerate([(0, 1), (3, 4), (6, 7)]):
        _put_conv(sd, f"input_zyx.{conv_i}", params[f"input_zyx_conv{i}"])
        _put_bn(sd, f"input_zyx.{bn_i}", params[f"input_zyx_bn{i}"], stats[f"input_zyx_bn{i}"])
    for i in range(_count(params, r"msrb_layer_(\d+)$")):
        _put_msrb(sd, f"msrb_layer.{i}", params[f"msrb_layer_{i}"], stats[f"msrb_layer_{i}"])
    _put_conv(sd, "output.0", params["output_conv"])
    return sd


def tpsf_net_state_dict(variables: Dict[str, dict]) -> dict:
    """JAX TPSFNet variables -> the port's ``TPSFNet`` state_dict."""
    params = variables["params"]
    sd: dict = {}
    for idx, torch_idx in enumerate([1, 3, 5, 7]):
        linear = params[f"mlp_{idx}"]["linear"]
        sd[f"MLP_layer.{torch_idx}.weight"] = _t(linear["kernel"]).T.contiguous()
        sd[f"MLP_layer.{torch_idx}.bias"] = _t(linear["bias"])
    return sd
