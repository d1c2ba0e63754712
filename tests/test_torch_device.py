"""The port's device utilities (``tactilesr_torch/runtime/device.py``) on a
machine without a GPU: the memory scan is empty, picking a GPU and the
CUDA burn-in raise as ``resolve_device`` does, and the burn-in runs on
the CPU when asked, at a shrunk matmul size."""

import pytest
import torch

from tactilesr_torch.runtime import device as tdev  # test_device is not a test: no bare import


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: these cases are the no-GPU behaviour")


def test_parse_device_memory_is_empty_without_gpu(no_gpu):
    assert tdev.parse_device_memory() == []


def test_select_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdev.select_device_with_most_free_memory()


def test_burn_in_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdev.test_device()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdev.test_device("cuda:0", test_time=0.01)


def test_burn_in_on_the_cpu(monkeypatch, capsys):
    """``device="cpu"`` times the bf16 matmul on the host: a positive TFLOP/s
    over whole batches of 8, and one printed line saying where it ran."""
    monkeypatch.setattr(tdev, "BURN_IN_N", 32)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tflops = tdev.test_device(device="cpu", test_time=0.05, test_memory_gb=32 * 32 * 2 * 3 / 2**30)
    finally:
        torch.set_num_threads(prev)
    assert tflops > 0
    out = capsys.readouterr().out
    assert "burn-in on cpu:" in out and "matmuls of 32x32 bf16" in out


def test_device_ops_keeps_device_kernels_only():
    """``device_ops`` keeps a trace's CUDA entries and drops the host's and
    the GPU-side user annotations, which span kernels already counted."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def entry(key, device_type, **kw):
        return SimpleNamespace(key=key, device_type=device_type, **kw)

    events = [entry("cudaLaunchKernel", DeviceType.CPU),
              entry("aten::conv2d", DeviceType.CPU, is_user_annotation=False),
              entry("sm90_xmma_fprop", DeviceType.CUDA),
              entry("Optimizer.step#Adam.step", DeviceType.CUDA, is_user_annotation=True),
              entry("Memcpy DtoH (Device -> Pinned)", DeviceType.CUDA, is_user_annotation=False)]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert [e.key for e in tdev.device_ops(prof)] == ["sm90_xmma_fprop", "Memcpy DtoH (Device -> Pinned)"]
