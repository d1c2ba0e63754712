"""The benchmark of tactilesr_torch on NVIDIA H100 cards: ``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
