"""Ops: torch-exact resize, tPSF physics (plain), and the CUDA kernels."""
