"""The CUDA kernels' build bookkeeping that runs without a GPU: reading
ptxas' resource lines.  Imports no JAX."""

import pytest

from tactilesr_torch.ops import cuda as tcuda

# the shape of ``nvcc -Xptxas -v`` output for the two kernels (names mangled
# inside the source's anonymous namespace), with a device function between
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b1c2_tpsf_kernel_cu_2f0d8e7a23tpsf_physics_bwd_kernelEPKfS1_S1_S1_PfS2_ffff' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__b1c2_tpsf_kernel_cu_2f0d8e7a23tpsf_physics_bwd_kernelEPKfS1_S1_S1_PfS2_ffff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _ZN45_GLOBAL__N__b1c2_tpsf_kernel_cu_2f0d8e7a8mbar_waitEPmj
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b1c2_tpsf_kernel_cu_2f0d8e7a19tpsf_physics_kernelEPKfS1_PfS2_ffff' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__b1c2_tpsf_kernel_cu_2f0d8e7a19tpsf_physics_kernelEPKfS1_PfS2_ffff
    0 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes smem, 384 bytes cmem[0]
"""


def test_ptxas_info_reads_each_kernel():
    info = tcuda.ptxas_info(PTXAS_LOG)
    assert info == {
        "tpsf_physics_bwd": dict(spill_stores=0, spill_loads=0, registers=118, static_smem=0),
        "tpsf_physics": dict(spill_stores=16, spill_loads=12, registers=80, static_smem=8),
    }


@pytest.mark.parametrize("log", ["", "nvcc warning : nothing about kernels\n"])
def test_ptxas_info_without_kernel_lines_is_empty(log):
    assert tcuda.ptxas_info(log) == {}


def test_kernel_names_are_the_launch_counters():
    assert set(tcuda.KERNELS.values()) <= set(tcuda.launch_counts)
