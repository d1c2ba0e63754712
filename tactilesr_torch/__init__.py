"""tactilesr_torch: the PyTorch/CUDA port of the tactile super-resolution
framework, for one NVIDIA H100.

It mirrors ``tactilesr_tpu``'s module names and is held against that package
by the tests, but imports nothing of it (nor of jax/flax): everything it
needs lives here.  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU; without a GPU they raise instead of falling back.

The tPSF physics kernel is CUDA C++ for ``sm_90a``
(``ops/cuda/tpsf_kernel.cu``), built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
