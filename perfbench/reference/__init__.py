"""Plain PyTorch reference of the benchmarked network, its lower-precision control, and the comparison that decides ``correct``.  Imports nothing of the program."""
