"""The yardstick's work counts and the card's peaks, frozen.

The FLOP counts are copies of ``tactilesr_torch/bench.py::
sr_flops_per_frame`` (tested there against forward hooks): the
original graph's convolutions, 2 x MACs, at (4 x scale)^2 pixels; resizes,
BatchNorm and activations left out, and the fused serving graph's zero
taps (a 3x3 kernel embedded in a 5x5 one) not counted.  They stay as they
are when the program's graph changes, so every roofline and ``mfu``
metric counts the same work whatever computes it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12

TRAIN_FORWARDS = 3  # a training step counted as three forwards (forward, two backward GEMMs)


def sr_flops_per_frame(scale=10, seqs=1, pattern_layers=6, force_layers=1):
    """Forward conv FLOPs of one TactileSR frame; (total, parts)."""
    px = (4 * scale) ** 2

    def conv(cin, cout, k):
        return 2 * cin * cout * k * k * px

    branch = conv(3, 64, 3) + conv(64, 64, 3)
    msrb = conv(64, 64, 3) + conv(64, 64, 5) + conv(128, 128, 3) + conv(128, 128, 5) + conv(256, 64, 1)
    force = conv(3, 64, 3) + force_layers * 2 * conv(64, 64, 3)
    head = conv(128, 128, 3) + conv(128, 1, 3)
    parts = {"pattern branches": seqs * branch, "inputContact": conv(64 * seqs, 64, 3),
             "MSRBs": pattern_layers * msrb, "force branch": force, "head": head}
    return sum(parts.values()), parts


def config_flops_per_frame(config: dict) -> int:
    """``sr_flops_per_frame`` at a configuration file's widths."""
    return sr_flops_per_frame(config["scale_factor"], config["seqsCnt"],
                              config["patternFeatureExtraLayerCnt"],
                              config["forceFeatureExtraLayerCnt"])[0]


def frame_bytes(config: dict) -> int:
    """Bytes a served frame must cross HBM at least once: its f32 reading
    in and its f32 map out."""
    hw = 4 * config["scale_factor"]
    return 4 * (config["seqsCnt"] * config["axisCnt"] * 16 + hw * hw)


def least_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """The roofline's least time: the larger of operations over the peak
    and bytes over HBM bandwidth; (seconds, "operations" | "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BPS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
