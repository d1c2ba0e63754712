"""Serving-specialized TactileSR forward: the same function, a rewritten graph.

Exact rewrites applied once at load time (host-side, f32), as in
``tactilesr_tpu/models/inference.py``:

1. **BatchNorm folding**: eval-mode BN is the affine map
   ``(x - mean) * scale / sqrt(var + eps) + bias``; it folds into the
   preceding conv's kernel and bias, so the serving graph has no BN.
2. **Parallel-kernel merging**: MSRB's parallel 3x3 and 5x5 convs over the
   same input become one 5x5 conv (the 3x3 kernel zero-embedded, output
   channels stacked); its output *is* the concat.
3. **Concat-input splitting**: ``conv(cat(a, b)) == conv_a(a) + conv_b(b)``
   with the kernel split along input channels (bias on one half); applied
   to MSRB's confusion 1x1, the head's first conv and the branch fuse.

4. **Branch batching (MTSR)**: the S per-sequence input branches are
   channel-independent (branch ``s`` reads input channels ``3s..3s+3`` and
   writes features ``64s..64s+64``), so their concat is exactly one
   convolution with a block-diagonal kernel, or one grouped convolution
   (``groups=S``) with no extra taps.  ``branch_mode`` picks the layout:
   ``per_seq`` (S branch stacks and a split fuse conv, the whole story for
   STSR), ``dense`` (one 3S->64S and one 64S->64S block-diagonal conv, every
   off-diagonal tap zero), ``grouped`` (the same two convs with
   ``groups=S``, kernels stacked on the output axis) or ``mixed`` (dense
   first conv, grouped second: its zero taps cost 2*9*(21-3)*448*1600 =
   0.23 GFLOP per frame at S=7, scale 10).  In every batched mode the input
   is upsampled once for all 3S channels (the upsample is per channel) and
   the branch fuse is the original single 64S->64 conv.  On the H100
   ``grouped`` is no slower than ``per_seq`` at every serving bucket
   (PERF.md section 6, PR 11), so ``auto`` picks it for S>1 at every batch.

On CUDA, kernels are stored channels-last (NHWC) in the compute dtype,
biases in f32, and every activation between the upsampled input and the
head's output is channels-last; on the CPU the layout stays NCHW.  Each
convolution is one call of :func:`_conv` with its epilogue as arguments,
``relu(conv(x, k) + z + b)``: a bias, a tensor added to its result (a
residual or a partial sum) and a ReLU.  On a CUDA bf16 tensor a convolution
with a ReLU is one cuDNN call that runs the epilogue in f32 before the one
rounding to bf16 (``torch.cudnn_convolution_relu``,
``torch.cudnn_convolution_add_relu``); cuDNN fuses only NHWC tensors, hence
the layout.  A convolution with no ReLU, and every one on the CPU, in f32 or
inside ``torch.export``, runs as ``F.conv2d``, then the adds and the ReLU in
that order.  The forwards add their conv calls, and those that ran fused,
into ``counts`` where one is given.

:func:`fold_inference_params` takes the port's ``TactileSR`` state_dict
(the reference layout); :func:`tactile_sr_infer` is the forward.
:func:`fold_inference_params_cnn` and :func:`tactile_sr_cnn_infer` are the
same for ``TactileSRCNN``: BN folded into its three input convs, each MSRB
merged and split as TactileSR's.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear_nchw, upsample_bilinear
from .layers import memory_format

__all__ = ["BRANCH_MODES", "fold_inference_params", "fold_inference_params_cnn",
           "resolve_branch_mode", "tactile_sr_infer", "tactile_sr_cnn_infer"]

_EPS = 1e-5  # torch BatchNorm2d default

BRANCH_MODES = ("per_seq", "dense", "grouped", "mixed")


def resolve_branch_mode(branch_mode: str, seqs_cnt: int) -> str:
    """The MTSR branch layout (module docstring, rewrite 4): ``auto`` is
    ``grouped`` for S>1 (no extra taps) and ``per_seq`` for S=1, where there
    is nothing to batch."""
    if branch_mode == "auto":
        return "grouped" if seqs_cnt > 1 else "per_seq"
    if branch_mode not in BRANCH_MODES:
        raise ValueError(f"branch_mode must be 'auto' or one of {BRANCH_MODES}, got {branch_mode!r}")
    return branch_mode


class _Reader:
    """A state_dict view that records which keys the fold read."""

    def __init__(self, sd: dict):
        self.sd = sd
        self.read: set = set()

    def __call__(self, key: str) -> torch.Tensor:
        self.read.add(key)
        return self.sd[key].detach().to("cpu", torch.float32)


def _check_all_consumed(sd: dict, read: set, hint: str) -> None:
    """Refuse a checkpoint with modules the requested architecture does not
    read (e.g. pattern_layers=1 on a 6-layer checkpoint would otherwise
    fold a truncated network and serve garbage)."""
    extra = sorted(
        {k.rsplit(".", 1)[0] for k in sd if k not in read and not k.endswith("num_batches_tracked")}
    )
    if extra:
        raise ValueError(
            f"checkpoint contains modules the requested architecture does "
            f"not consume: {extra} -- {hint}"
        )


def _fold_bn(rd: _Reader, conv: str, bn: str, has_bias: bool = False):
    """Fold eval-mode BN ``bn`` into conv ``conv`` -> (kernel OIHW, bias)."""
    k = rd(f"{conv}.weight")
    s = rd(f"{bn}.weight") / torch.sqrt(rd(f"{bn}.running_var") + _EPS)
    b = rd(f"{conv}.bias") if has_bias else torch.zeros(k.shape[0])
    b = (b - rd(f"{bn}.running_mean")) * s + rd(f"{bn}.bias")
    return k * s[:, None, None, None], b


def _embed_3_in_5(k3: torch.Tensor) -> torch.Tensor:
    """Zero-embed an OIHW 3x3 kernel at the center of a 5x5 window."""
    out = torch.zeros(k3.shape[0], k3.shape[1], 5, 5)
    out[:, :, 1:4, 1:4] = k3
    return out


def _fold_msrb(rd: _Reader, src: str, pre: str, out: dict) -> None:
    def fold(name):
        return _fold_bn(rd, f"{src}.{name}.0", f"{src}.{name}.1", has_bias=True)

    k3, b3 = fold("conv_3_1")
    k5, b5 = fold("conv_5_1")
    out[f"{pre}/stage1/k"] = torch.cat([_embed_3_in_5(k3), k5], dim=0)
    out[f"{pre}/stage1/b"] = torch.cat([b3, b5])
    out[f"{pre}/conv32/k"], out[f"{pre}/conv32/b"] = fold("conv_3_2")
    out[f"{pre}/conv52/k"], out[f"{pre}/conv52/b"] = fold("conv_5_2")
    ck = rd(f"{src}.confusion.weight")
    half = ck.shape[1] // 2
    out[f"{pre}/conf/k32"] = ck[:, :half]
    out[f"{pre}/conf/k52"] = ck[:, half:]
    out[f"{pre}/conf/b"] = rd(f"{src}.confusion.bias")


def fold_inference_params(
    state_dict: dict,
    *,
    seqs_cnt: int = 1,
    pattern_layers: int = 6,
    force_layers: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    branch_mode: str = "per_seq",
) -> dict:
    """Rewrite a TactileSR state_dict into the fused serving layout.

    Returns a flat dict of tensors on ``device``: kernels (OIHW) in
    ``dtype``, biases in f32 (cast to the activation dtype at the add).
    ``branch_mode`` picks the branch layout (module docstring, rewrite 4);
    :func:`tactile_sr_infer` must be given the same one.  Raises
    ``KeyError`` on a missing parameter and ``ValueError`` when the
    checkpoint holds modules the requested architecture would not read or
    the mode is unknown.
    """
    branch_mode = resolve_branch_mode(branch_mode, seqs_cnt)
    rd = _Reader(state_dict)
    out: dict = {}
    folds = [[_fold_bn(rd, f"inputLayer_pattern_list.{s}.{conv_i}", f"inputLayer_pattern_list.{s}.{bn_i}")
              for conv_i, bn_i in ((1, 2), (4, 5))] for s in range(seqs_cnt)]
    ick, icb = _fold_bn(rd, "inputContact_layer.0", "inputContact_layer.1")
    if branch_mode == "per_seq":
        for s, convs in enumerate(folds):
            for idx, (k, b) in enumerate(convs):
                out[f"inputLayer_pattern_{s}_conv{idx}/k"] = k
                out[f"inputLayer_pattern_{s}_conv{idx}/b"] = b
        for s in range(seqs_cnt):  # the fuse conv reads cat(branch_0..): split it
            out[f"inputContact/k{s}"] = ick[:, s * 64:(s + 1) * 64]
    else:
        # grouped kernels stack on the output axis (groups=S); dense ones
        # are block-diagonal: branch s maps inputs [cin*s, cin*s+cin) to
        # features [64s, 64s+64), every other tap zero
        for idx, dense in ((0, branch_mode != "grouped"), (1, branch_mode == "dense")):
            ks = [convs[idx][0] for convs in folds]
            if len({k.shape for k in ks}) > 1:
                raise ValueError(f"the {seqs_cnt} branches' conv{idx} kernels differ in shape "
                                 f"({[tuple(k.shape) for k in ks]}): no {branch_mode} layout")
            if dense:
                co, ci = ks[0].shape[:2]
                k = torch.zeros(co * seqs_cnt, ci * seqs_cnt, 3, 3)
                for s, ks_ in enumerate(ks):
                    k[s * co:(s + 1) * co, s * ci:(s + 1) * ci] = ks_
            else:
                k = torch.cat(ks)
            out[f"branches/k{idx}"] = k
            out[f"branches/b{idx}"] = torch.cat([convs[idx][1] for convs in folds])
        out["inputContact/k"] = ick  # reads the concat as it is: not split
    out["inputContact/b"] = icb

    for i in range(pattern_layers):
        _fold_msrb(rd, f"patternFeatureExtra_layer.{i}", f"msrb_{i}", out)

    out["force_in/k"] = rd("input_layer_force.1.weight")
    for i in range(force_layers):
        src = f"forceFeatureExtra_layer.{i}"
        for c in ("conv1", "conv2"):
            out[f"res_{i}/{c}/k"] = rd(f"{src}.{c}.weight")
            out[f"res_{i}/{c}/b"] = rd(f"{src}.{c}.bias")

    hk = rd("output_layer.0.weight")  # reads cat(force, pattern): split
    out["head0/kf"] = hk[:, :64]
    out["head0/kp"] = hk[:, 64:]
    out["head1/k"] = rd("output_layer.2.weight")

    _check_all_consumed(
        state_dict, rd.read,
        f"do seqs_cnt={seqs_cnt}, pattern_layers={pattern_layers}, "
        f"force_layers={force_layers} match the trained architecture?",
    )
    return _placed(out, dtype, device)


def fold_inference_params_cnn(
    state_dict: dict,
    *,
    msrb_cnt: int = 6,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
) -> dict:
    """Rewrite a TactileSRCNN state_dict into its fused serving layout: BN
    folded into the three input convs, every MSRB merged and split as in
    :func:`fold_inference_params`.  Same return value and errors."""
    rd = _Reader(state_dict)
    out: dict = {}
    for i, (conv_i, bn_i) in enumerate([(0, 1), (3, 4), (6, 7)]):
        out[f"in{i}/k"], out[f"in{i}/b"] = _fold_bn(rd, f"input_zyx.{conv_i}", f"input_zyx.{bn_i}")
    for i in range(msrb_cnt):
        _fold_msrb(rd, f"msrb_layer.{i}", f"msrb_{i}", out)
    out["head/k"] = rd("output.0.weight")
    _check_all_consumed(
        state_dict, rd.read,
        f"does msrb_cnt={msrb_cnt} match the trained TactileSRCNN (and is this really a "
        "TactileSRCNN checkpoint)?",
    )
    return _placed(out, dtype, device)


def _placed(out: dict, dtype: torch.dtype, device) -> dict:
    """Kernels (``.../k*``) in ``dtype`` and :func:`~.layers.memory_format`,
    biases in f32, on ``device``."""
    return {
        k: v.to(device, dtype).contiguous(memory_format=memory_format(device))
        if k.rsplit("/", 1)[-1].startswith("k") else v.to(device, torch.float32).contiguous()
        for k, v in out.items()
    }


def _fusable(x: torch.Tensor) -> bool:
    """Whether cuDNN runs a convolution's epilogue in the same call: on a
    CUDA bf16 tensor, outside ``torch.export`` (the fused ops have no fake
    kernel to trace).  At bucket 1024 on the H100 the fused call beats the
    split one in every signature of the graph (PERF.md section 6, PR 17)."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not torch.compiler.is_exporting()


def _conv(x, kernel, bias=None, *, z=None, relu: bool = False, pad: int, groups: int = 1,
          counts: dict | None = None):
    """``relu(conv(x, kernel) + z + bias)``, each of ``z``, ``bias`` and the
    ReLU optional, in :func:`~.layers.memory_format`: one cuDNN call where
    :func:`_fusable`, else the convolution, then the adds and the ReLU in
    that order.

    The fused call reads the bias in the compute dtype: with an f32 bias
    cuDNN has only engines it compiles at run time, 0.5-3.5 s a signature.
    Output channels are padded with zero filters to a multiple of 8 there
    (the 1-channel head), and the result is sliced: cuDNN pads such a
    convolution itself, and transposes it to NCHW and back."""
    fused = relu and _fusable(x)
    if counts is not None:
        counts["convs"] = counts.get("convs", 0) + 1
        counts["fused_convs"] = counts.get("fused_convs", 0) + int(fused)
    if fused:
        co = kernel.shape[0]
        if co % 8:
            padded = torch.empty((co + 8 - co % 8, *kernel.shape[1:]), dtype=kernel.dtype,
                                 device=kernel.device, memory_format=torch.channels_last).zero_()
            padded[:co] = kernel
            kernel = padded
        bias = None if bias is None else bias.to(x.dtype)
        if z is None:
            y = torch.cudnn_convolution_relu(x, kernel, bias, (1, 1), (pad, pad), (1, 1), groups)
        else:
            y = torch.cudnn_convolution_add_relu(x, kernel, z, 1, bias, (1, 1), (pad, pad), (1, 1), groups)
        return y[:, :co] if co % 8 else y
    y = F.conv2d(x, kernel, padding=pad, groups=groups)
    if z is not None:
        y.add_(z)
    if bias is not None:
        y.add_(bias[:, None, None])
    return y.relu_() if relu else y


def _upsampled(x: torch.Tensor, scale_factor: int, dtype: torch.dtype) -> torch.Tensor:
    """The upsampled readings in the compute dtype and
    :func:`~.layers.memory_format`."""
    return upsample_bilinear(x, scale_factor).to(dtype, memory_format=memory_format(x.device))


def _msrb_infer(folded: dict, pre: str, x, conv):
    mid = conv(x, folded[f"{pre}/stage1/k"], folded[f"{pre}/stage1/b"], relu=True, pad=2)
    o32 = conv(mid, folded[f"{pre}/conv32/k"], folded[f"{pre}/conv32/b"], relu=True, pad=1)
    o52 = conv(mid, folded[f"{pre}/conv52/k"], folded[f"{pre}/conv52/b"], relu=True, pad=2)
    # relu(conf(cat(o32, o52)) + x), the residual added to the first half's partial sum
    t = conv(o32, folded[f"{pre}/conf/k32"], z=x, pad=0)
    return conv(o52, folded[f"{pre}/conf/k52"], folded[f"{pre}/conf/b"], z=t, relu=True, pad=0)


@torch.no_grad()
def tactile_sr_infer(
    folded: dict,
    x: torch.Tensor,
    *,
    scale_factor: int = 10,
    seqs_cnt: int = 1,
    axis_cnt: int = 3,
    pattern_layers: int = 6,
    force_layers: int = 1,
    branch_mode: str = "per_seq",
    counts: dict | None = None,
) -> torch.Tensor:
    """Fused serving forward: (B, seqs*axis, 4, 4) f32 -> (B, 1, 4s, 4s) f32.

    The same function as ``TactileSR.eval()(x)``; ``folded`` comes from
    :func:`fold_inference_params` with the same ``branch_mode`` and sets
    the compute dtype.  ``counts``, where given, gains the forward's conv
    calls (``convs``) and those whose epilogue cuDNN ran (``fused_convs``)."""
    branch_mode = resolve_branch_mode(branch_mode, seqs_cnt)
    dt = folded["head1/k"].dtype
    conv = functools.partial(_conv, counts=counts)
    x = x.float()

    if branch_mode == "per_seq":
        acc = None  # the fuse conv over cat(branch_0..): a sum of split convs
        for s in range(seqs_cnt):
            last = s == seqs_cnt - 1
            h = _upsampled(x[:, s * axis_cnt:(s + 1) * axis_cnt], scale_factor, dt)
            h = conv(h, folded[f"inputLayer_pattern_{s}_conv0/k"],
                     folded[f"inputLayer_pattern_{s}_conv0/b"], relu=True, pad=1)
            h = conv(h, folded[f"inputLayer_pattern_{s}_conv1/k"],
                     folded[f"inputLayer_pattern_{s}_conv1/b"], relu=True, pad=1)
            acc = conv(h, folded[f"inputContact/k{s}"], folded["inputContact/b"] if last else None,
                       z=acc, relu=last, pad=1)
        pattern = acc
    else:  # rewrite 4: all S branches as two convolutions
        g0 = seqs_cnt if branch_mode == "grouped" else 1
        g1 = 1 if branch_mode == "dense" else seqs_cnt
        h = _upsampled(x[:, :seqs_cnt * axis_cnt], scale_factor, dt)
        h = conv(h, folded["branches/k0"], folded["branches/b0"], relu=True, pad=1, groups=g0)
        h = conv(h, folded["branches/k1"], folded["branches/b1"], relu=True, pad=1, groups=g1)
        pattern = conv(h, folded["inputContact/k"], folded["inputContact/b"], relu=True, pad=1)

    for i in range(pattern_layers):
        pattern = _msrb_infer(folded, f"msrb_{i}", pattern, conv)

    force = conv(_upsampled(x[:, :axis_cnt], scale_factor, dt), folded["force_in/k"], relu=True, pad=1)
    for i in range(force_layers):
        y = conv(force, folded[f"res_{i}/conv1/k"], folded[f"res_{i}/conv1/b"], relu=True, pad=1)
        force = conv(y, folded[f"res_{i}/conv2/k"], folded[f"res_{i}/conv2/b"], z=force, relu=True, pad=1)

    out = conv(pattern, folded["head0/kp"], z=conv(force, folded["head0/kf"], pad=1), relu=True, pad=1)
    out = conv(out, folded["head1/k"], relu=True, pad=1)
    hw = 4 * scale_factor
    return resize_bilinear_nchw(out, (hw, hw)).float()


@torch.no_grad()
def tactile_sr_cnn_infer(
    folded: dict,
    x: torch.Tensor,
    *,
    scale_factor: int = 10,
    msrb_cnt: int = 6,
    counts: dict | None = None,
) -> torch.Tensor:
    """Fused serving forward of TactileSRCNN: (B, 3, 4, 4) f32 -> (B, 1, 4s,
    4s) f32, the same function as ``TactileSRCNN.eval()(x)``; ``folded``
    comes from :func:`fold_inference_params_cnn` and sets the compute dtype;
    ``counts`` as in :func:`tactile_sr_infer`."""
    dt = folded["head/k"].dtype
    conv = functools.partial(_conv, counts=counts)
    h = _upsampled(x.float(), scale_factor, dt)
    for i in range(3):
        h = conv(h, folded[f"in{i}/k"], folded[f"in{i}/b"], relu=True, pad=1)
    for i in range(msrb_cnt):
        h = _msrb_infer(folded, f"msrb_{i}", h, conv)
    return conv(h, folded["head/k"], relu=True, pad=1).float()
