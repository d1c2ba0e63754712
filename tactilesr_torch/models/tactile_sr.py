"""TactileSR, the ToH-2024 SR network (STSR when ``seqs_cnt == 1``), and
TactileSRCNN, the IROS-2022 single-frame baseline.

Per-sequence-frame pattern branch (bilinear x-scale upsample, then two
conv3x3-BN-ReLU), branch concat, fuse conv-BN-ReLU, MSRB trunk; a parallel
force branch on the first frame (upsample, conv3x3, ReLU, ResBlocks);
concat(force, pattern), then a two-conv head (reference
model/tactileSR_model.py:18-98).  Input (B, seqs*3, 4, 4), output
(B, 1, 4*scale, 4*scale) f32.

Module names follow the reference's state_dict layout (the one
``tactilesr_tpu/compat/export_torch.py`` writes), so such a state_dict
loads with ``strict=True``: ``inputLayer_pattern_list.{s}.{1,2,4,5}``,
``inputContact_layer.{0,1}``, ``patternFeatureExtra_layer.{i}.*``,
``input_layer_force.1``, ``forceFeatureExtra_layer.{i}.conv{1,2}``,
``output_layer.{0,2}``.  Parameters stay f32; ``dtype`` is the activation
dtype (BN in f32), as in the JAX module.

``head_init`` picks the final head kernel's init (``output_layer.2``, a
bias-free conv before the last ReLU): ``"reference"`` keeps the Kaiming
fan_out draw, ``"non_negative"`` folds that same draw to |w| / sqrt(fan_in)
so the head cannot be born dead.  The parameter tree is the same either
way.  In ``train()`` mode the BatchNorms normalise by the batch statistics
and update their running statistics (torch's momentum 0.1 and unbiased
running variance, as the JAX ``BatchNorm``).

``TactileSRCNN`` (reference model/tactileSR_model.py:101-153, the JAX
package's ``tactile_sr.py:132-161``): bilinear x``scale_factor`` upsample,
3 x (conv3x3 64, BN, ReLU) as ``input_zyx.{0,1,3,4,6,7}``, ``msrb_cnt``
MSRBs as ``msrb_layer.{i}``, and a bias-free 3x3 head to one channel, then
ReLU, as ``output.0``.  Input (B, 3, 4, 4), output (B, 1, 4*scale, 4*scale)
f32; the same ``dtype``, ``generator`` and ``head_init`` rules as TactileSR.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear_nchw, upsample_bilinear
from .blocks import MSRB, ResBlock
from .layers import BatchNorm, Conv, fold_non_negative_, init_weights_

__all__ = ["TactileSR", "TactileSRCNN", "TAXEL_CNT", "HEAD_INITS"]

TAXEL_CNT = 4  # the Xela sensor is a 4x4 taxel grid
HEAD_INITS = ("reference", "non_negative")


class Upsample(nn.Module):
    """Parameter-free torch-exact bilinear upsample by an integer factor."""

    def __init__(self, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x):
        return upsample_bilinear(x, self.scale_factor)


def _check_head_init(head_init: str) -> None:
    if head_init not in HEAD_INITS:
        raise ValueError(f"head_init must be one of {sorted(HEAD_INITS)}, got {head_init!r}")


class TactileSR(nn.Module):
    def __init__(
        self,
        scale_factor: int = 10,
        seqs_cnt: int = 1,
        axis_cnt: int = 3,
        pattern_feature_extra_layer_cnt: int = 6,
        force_feature_extra_layer_cnt: int = 1,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        head_init: str = "reference",
    ):
        super().__init__()
        _check_head_init(head_init)
        self.scale_factor = scale_factor
        self.seqs_cnt = seqs_cnt
        self.axis_cnt = axis_cnt
        self.dtype = dtype

        self.inputLayer_pattern_list = nn.ModuleList(
            nn.Sequential(
                Upsample(scale_factor),
                Conv(axis_cnt, 64, 3, bias=False, branch=True), BatchNorm(64), nn.ReLU(),
                Conv(64, 64, 3, bias=False, branch=True), BatchNorm(64), nn.ReLU(),
            )
            for _ in range(seqs_cnt)
        )
        self.inputContact_layer = nn.Sequential(
            Conv(64 * seqs_cnt, 64, 3, bias=False), BatchNorm(64), nn.ReLU()
        )
        self.patternFeatureExtra_layer = nn.ModuleList(
            MSRB(64) for _ in range(pattern_feature_extra_layer_cnt)
        )
        self.input_layer_force = nn.Sequential(
            Upsample(scale_factor), Conv(axis_cnt, 64, 3, bias=False), nn.ReLU()
        )
        self.forceFeatureExtra_layer = nn.ModuleList(
            ResBlock(64) for _ in range(force_feature_extra_layer_cnt)
        )
        self.output_layer = nn.Sequential(
            Conv(128, 128, 3, bias=False), nn.ReLU(), Conv(128, 1, 3, bias=False), nn.ReLU()
        )

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)
        if head_init == "non_negative":  # the head is drawn last: no other draw changes
            fold_non_negative_(self.output_layer[2].weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.seqs_cnt * self.axis_cnt:
            raise ValueError(
                "input channels must equal seqs_cnt * axis_cnt "
                f"(got {x.shape[1]} != {self.seqs_cnt}*{self.axis_cnt})"
            )
        x = x.to(self.dtype)
        a = self.axis_cnt
        pattern = torch.cat(
            [branch(x[:, s * a:(s + 1) * a]) for s, branch in enumerate(self.inputLayer_pattern_list)],
            dim=1,
        )
        pattern = self.inputContact_layer(pattern)
        for blk in self.patternFeatureExtra_layer:
            pattern = blk(pattern)

        force = self.input_layer_force(x[:, :a])
        for blk in self.forceFeatureExtra_layer:
            force = blk(force)

        out = self.output_layer(torch.cat([force, pattern], dim=1))
        hw = TAXEL_CNT * self.scale_factor
        return resize_bilinear_nchw(out, (hw, hw)).float()


class TactileSRCNN(nn.Module):
    def __init__(
        self,
        scale_factor: int = 10,
        msrb_cnt: int = 6,
        axis_cnt: int = 3,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        head_init: str = "reference",
    ):
        super().__init__()
        _check_head_init(head_init)
        self.scale_factor = scale_factor
        self.seqs_cnt = 1
        self.axis_cnt = axis_cnt
        self.dtype = dtype
        self.upsample = Upsample(scale_factor)
        self.input_zyx = nn.Sequential(
            Conv(axis_cnt, 64, 3, bias=False), BatchNorm(64), nn.ReLU(),
            Conv(64, 64, 3, bias=False), BatchNorm(64), nn.ReLU(),
            Conv(64, 64, 3, bias=False), BatchNorm(64), nn.ReLU(),
        )
        self.msrb_layer = nn.ModuleList(MSRB(64) for _ in range(msrb_cnt))
        self.output = nn.Sequential(Conv(64, 1, 3, bias=False), nn.ReLU())

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)
        if head_init == "non_negative":  # the head is drawn last: no other draw changes
            fold_non_negative_(self.output[0].weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.axis_cnt:
            raise ValueError(f"TactileSRCNN takes {self.axis_cnt} input channels, got {x.shape[1]}")
        h = self.input_zyx(self.upsample(x.to(self.dtype)))
        for blk in self.msrb_layer:
            h = blk(h)
        return self.output(h).float()
