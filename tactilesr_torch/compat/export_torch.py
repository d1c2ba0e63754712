"""A JAX ``.ckpt`` bundle -> the port's ``.pth`` bundle (the port of
``tactilesr_tpu/compat/export_torch.py``).

The ``.ckpt`` is read with ``runtime/checkpoint.py::read_ckpt`` (plain
msgpack, no flax) and its ``model`` tree mapped by ``compat/from_jax.py``.
The written bundle is the port's (``{"model": state_dict, "epoch",
"num_devices", ...}``, loadable with ``weights_only=True``) and carries the
reference's ``num_gpus`` beside it, so the reference's model-loading paths
read it as they read JAX's export.  Model weights only: the optimizer,
schedule and metric state of a JAX trainer bundle are not carried (JAX's
export does the same).

    python -m tactilesr_torch.compat.export_torch model.ckpt model.pth [--arch tactileSR]
"""

from __future__ import annotations

import logging

from ..runtime.checkpoint import jax_arch, read_ckpt, save_checkpoint_file

__all__ = ["ARCHS", "export_checkpoint_file"]

logger = logging.getLogger("tactilesr_torch")

ARCHS = ("tPSFNet", "tactileSR", "tactileSRCNN")


def export_checkpoint_file(ckpt_path: str, pth_path: str, arch: str = "tactileSR") -> str:
    """One-shot migration: a JAX ``.ckpt`` bundle -> a port ``.pth``.
    Raises ValueError when the file holds another architecture than
    ``arch``."""
    if arch not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")
    bundle = read_ckpt(ckpt_path)
    model = bundle["model"]
    found, bridge = jax_arch(model)
    if found != arch:
        raise ValueError(f"{ckpt_path!r} holds a {found} parameter tree, not {arch}")
    sd = bridge({"params": model["params"], "batch_stats": model.get("batch_stats", {})})
    n_dev = int(bundle.get("num_devices", 1))
    save_checkpoint_file(pth_path, sd, epoch=int(bundle.get("epoch", 0)), num_gpus=n_dev,
                         exported_from=ckpt_path)
    logger.info("exported %s (%s) -> %s", ckpt_path, arch, pth_path)
    return pth_path


def _cli(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m tactilesr_torch.compat.export_torch",
        description="Export a JAX .ckpt bundle to a port (and reference-loadable) torch .pth",
    )
    p.add_argument("ckpt")
    p.add_argument("pth")
    p.add_argument("--arch", choices=ARCHS, default="tactileSR")
    args = p.parse_args(argv)
    export_checkpoint_file(args.ckpt, args.pth, arch=args.arch)


if __name__ == "__main__":
    _cli()
