"""``SRPredictor.predict``'s chunk pipeline on the GPU (``serving.py``):
pinned staging slots, non-blocking copies both ways, chunk k fetched after
chunk k+1 is enqueued, at the benchmark's widths (STSR and the 7-reading
MTSR, scale 10, 6 MSRB, bf16) on the benchmark's seeded weights
(``perfbench/weights.py``).  Every test here needs an NVIDIA GPU and skips
without one.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda_serving_pipeline.py -q

No tolerance: the pipeline moves bytes and computes nothing, so its maps
are bit-equal to a chunk-by-chunk forward of the same padded chunks.
"""

import json
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.common import program_widths, write_checkpoint
from perfbench.inputs import readings
from perfbench.weights import seeded_state_dict
from tactilesr_torch.serving import SRPredictor

pytestmark = pytest.mark.gpu

CONFIGS = Path(__file__).resolve().parent.parent / "perfbench" / "configs"
SEED = 5000000003
SIZES = [1, 7, 1023, 1024, 1025, 3000, 8192]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned staging and non-blocking copies run only there)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["stsr-x10", "mtsr7-x10"])
def served(request, dev):
    """(warmed-up bf16 predictor at the default buckets, readings maker)."""
    cfg = json.loads((CONFIGS / f"{request.param}.json").read_text())
    path = write_checkpoint(seeded_state_dict(cfg, SEED, dev), tempfile.mkdtemp())
    pred = SRPredictor(path, device=dev, **program_widths(cfg))
    pred.warmup()
    chans = cfg["seqsCnt"] * cfg["axisCnt"]
    return pred, lambda i, n: readings(SEED, i, n, chans, 0.0, 4.0)


def _chunk_by_chunk(pred, lr):
    """Each chunk zero-padded to its bucket, its forward fetched at once."""
    outs, i = [], 0
    while i < len(lr):
        b = pred._bucket(len(lr) - i)
        take = min(b, len(lr) - i)
        chunk = np.zeros((b,) + lr.shape[1:], np.float32)
        chunk[:take] = lr[i:i + take]
        outs.append(pred._forward(pred._weights, torch.from_numpy(chunk).to(pred.device)).cpu()[:take].numpy())
        i += take
    return np.concatenate(outs)


def _slots(pred):
    return [t for st in pred._staging for t in st.inputs + st.outputs]


def test_the_slots_are_pinned(served):
    pred, _ = served
    assert all(t.is_pinned() for t in _slots(pred))


@pytest.mark.parametrize("n", SIZES)
def test_predict_is_the_chunk_by_chunk_forward(served, n):
    pred, make = served
    lr = make(n, n)
    got = pred.predict(lr)
    assert got.shape == (n, 1, 40, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _chunk_by_chunk(pred, lr))


def test_a_result_outlives_the_next_requests_and_owns_its_memory(served):
    """Three requests back to back (8 chunks, then a padded one, then 8
    again): the first answer is unchanged after the other two, and no
    answer shares memory with a staging slot."""
    pred, make = served
    inputs = [make(0, 8192), make(1, 1000), make(2, 8192)]
    first_want = _chunk_by_chunk(pred, inputs[0])
    answers = [pred.predict(x) for x in inputs]
    np.testing.assert_array_equal(answers[0], first_want)
    for a in answers:
        assert a.flags.owndata
        for t in _slots(pred):
            assert not np.shares_memory(a, t.numpy())


def test_two_threads_each_get_their_own_answer(served):
    pred, make = served
    inputs = [make(10, 3000), make(11, 2100)]
    wants = [_chunk_by_chunk(pred, x) for x in inputs]
    got = [[], []]
    errors = []

    def call(k):
        try:
            for _ in range(4):
                got[k].append(pred.predict(inputs[k]))
        except Exception as e:  # reported below, with the thread's inputs
            errors.append((k, e))

    threads = [threading.Thread(target=call, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for k in range(2):
        assert len(got[k]) == 4
        for a in got[k]:
            np.testing.assert_array_equal(a, wants[k])


def test_requests_after_warmup_allocate_no_staging(served):
    pred, make = served
    before = [t.data_ptr() for t in _slots(pred)]
    for i in range(3):
        pred.predict(make(20 + i, 2500))
    assert [t.data_ptr() for t in _slots(pred)] == before
