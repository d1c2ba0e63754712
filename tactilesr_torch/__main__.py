"""``python -m tactilesr_torch``: the command index of the port's entry points."""

import sys

COMMANDS = [
    ("-m tactilesr_torch.tasks.tpsf_task", "stage 1: fit the PSF physics model (tPSFNet)"),
    ("-m tactilesr_torch.tasks.sr_task", "stage 3: single-frame SR (STSR; --model_arch TactileSRCNN)"),
    ("-m tactilesr_torch.tasks.sr_seqs_task", "stage 4: multi-frame SR (MTSR) with trunk transfer"),
    ("-m tactilesr_torch.data.generate", "synthetic raw blobs / SRdataset / SeqsDataset generation"),
    ("-m tactilesr_torch.serving", "batched SR inference from a checkpoint (+ --evaluate)"),
    ("-m tactilesr_torch.server", "micro-batched HTTP serving endpoint"),
    ("-m tactilesr_torch.bench", "time a tPSF physics kernel against its plain version (one JSON line)"),
    ("-m tactilesr_torch.graft_entry", "data-parallel dry run of the recipes over --ranks N processes"),
    ("-m tactilesr_torch.compat.torch_convert", "port or reference .pth -> JAX .ckpt"),
    ("-m tactilesr_torch.compat.export_torch", "JAX .ckpt -> port (and reference-loadable) .pth"),
]


def main() -> int:
    print("tactilesr_torch -- the PyTorch/CUDA port of the tactile super-resolution framework\n")
    print("usage: python <command> --help   (entries run on cuda; --device cpu for the CPU)\n")
    width = max(len(c) for c, _ in COMMANDS) + 7  # len("python ")
    for cmd, desc in COMMANDS:
        print(f"  {'python ' + cmd:<{width}}  {desc}")
    print("\ndocs: README.md, PERF.md, ROADMAP.md")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `python -m tactilesr_torch | head -1`
        sys.exit(0)
