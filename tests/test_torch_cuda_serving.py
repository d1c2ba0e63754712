"""The fused serving graph on the GPU (``models/inference.py``): NHWC
activations, each convolution's bias, residual and ReLU in cuDNN's
epilogue, at the benchmark's widths (STSR and the 7-reading MTSR, scale 10,
6 MSRB) on the benchmark's seeded weights (``perfbench/weights.py``).
Every test here needs an NVIDIA GPU and skips without one.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda_serving.py -q

Tolerances: the bf16 graph against the plain f32 reference (NCHW, TF32
off; ``perfbench/reference/``) by the benchmark's own numbers, ``rel_rms``
(RMS gap over the reference's RMS) and ``worst_row`` (the worst frame's),
within the NCHW bf16 graph's largest readings over the 12 seeds that set
the bulk cells' limits (PERF.md section 2: STSR 0.008373 / 0.01927, MTSR
0.00652 / 0.01042), on weights and readings of one of those seeds.  The f32
graph (the decomposition in NHWC) against the same reference: rtol and
atol 1e-4 of the reference's largest value, as ``chip_smoke.py``'s serving
phases hold the f32 fused graph.
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.common import program_widths, reference_outputs, write_checkpoint
from perfbench.inputs import readings
from perfbench.reference.compare import serving_numbers
from perfbench.weights import seeded_state_dict
from tactilesr_torch.serving import SRPredictor, export_program

pytestmark = pytest.mark.gpu

CONFIGS = Path(__file__).resolve().parent.parent / "perfbench" / "configs"
# the NCHW bf16 graph's largest (rel_rms, worst_row) over the 12 seeds
# 5000000001-12 (PERF.md section 2), and its device ops a bucket-1024 forward
PARENT_ERROR = {"stsr-x10": (0.008373, 0.01927), "mtsr7-x10": (0.00652, 0.01042)}
PARENT_OPS = {"stsr-x10": 262, "mtsr7-x10": 268}
# convs a forward, and those whose epilogue cuDNN runs: all but the plain
# ones (the confusion's first half in each MSRB, the head's first half)
CONVS = {"stsr-x10": (39, 32), "mtsr7-x10": (39, 32)}
SEED = 5000000002


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (cuDNN's fused convolutions run only there)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=sorted(PARENT_ERROR))
def served(request, dev):
    """(config, seeded state, bf16 predictor, 1024 frames, f32 reference)."""
    cfg = json.loads((CONFIGS / f"{request.param}.json").read_text())
    state = seeded_state_dict(cfg, SEED, dev)
    path = write_checkpoint(state, tempfile.mkdtemp())
    pred = SRPredictor(path, device=dev, **program_widths(cfg))
    frames = torch.from_numpy(readings(SEED, 0, 1024, cfg["seqsCnt"] * cfg["axisCnt"], 0.0, 4.0)).to(dev)
    return request.param, cfg, path, pred, frames, reference_outputs(cfg, state, frames)


@pytest.mark.parametrize("batch", [1, 5, 1024])
def test_fused_bf16_graph_is_within_the_nchw_graphs_error(served, batch):
    name, _, _, pred, frames, ref = served
    x = frames[:batch]
    got = pred._forward(pred._weights, x)
    assert got.shape == (batch, 1, 40, 40) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, pred._forward(pred._weights, x))
    numbers = serving_numbers(got, ref[:batch])
    rel_rms, worst_row = PARENT_ERROR[name]
    assert numbers["rel_rms"] <= rel_rms and numbers["worst_row"] <= worst_row, numbers


def test_f32_graph_matches_the_reference(served, dev):
    name, cfg, path, _, frames, ref = served
    pred = SRPredictor(path, device=dev, **dict(program_widths(cfg), compute_dtype="float32"))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = pred._forward(pred._weights, frames[:64])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    span = float(ref[:64].abs().max())
    torch.testing.assert_close(got, ref[:64], rtol=1e-4, atol=1e-4 * span)


def test_a_bucket_1024_forward_has_no_transposes(served):
    """One profiled forward: no cuDNN layout transpose, the counts of its
    conv calls, and at most half the NCHW graph's device ops (PERF.md
    section 6, PR 17): a conv kernel and cuDNN's memset a conv, a bias cast
    a fused biased conv, and the upsample, residual adds and padding."""
    name, _, _, pred, frames, _ = served
    pred._forward(pred._weights, frames)
    counts = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred._forward(pred._weights, frames, counts)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]
    convs, fused = CONVS[name]
    assert counts == {"convs": convs, "fused_convs": fused}
    assert len(names) <= PARENT_OPS[name] // 2, sorted(set(names))


def test_export_program_round_trips(served, dev):
    """``torch.export`` traces the decomposition (the fused ops have no fake
    kernel); the reloaded program is within the same error of the
    reference as the served graph."""
    name, cfg, path, _, frames, ref = served
    out = export_program(path, tempfile.mktemp(suffix=".pt2"), batch=8, device=dev,
                         **{k: v for k, v in program_widths(cfg).items() if k != "axis_cnt"})
    got = torch.export.load(out).module()(frames[:8])
    numbers = serving_numbers(got, ref[:8])
    rel_rms, worst_row = PARENT_ERROR[name]
    assert numbers["rel_rms"] <= rel_rms and numbers["worst_row"] <= worst_row, numbers
    np.testing.assert_array_equal(got.cpu().numpy(), torch.export.load(out).module()(frames[:8]).cpu().numpy())
