"""The data-parallel layout (the port of ``tactilesr_tpu/parallel/mesh.py``).

JAX lays one ``Mesh`` over every device and lets XLA shard a global batch
over its ``data`` axis.  The port keeps that axis as a small frozen
``Mesh``: its size, this process's place on it, and, for serving inside
one process, the devices that hold a replica each.  Training runs one
process per device (``parallel/dist.py``): every rank holds the whole
dataset and the whole state, takes its contiguous block of rows of each
(micro-)batch, and the trainer sums the gradients over the ranks.

JAX's ``put_global`` and ``host_local_copy`` have no counterpart: each rank
holds whole tensors, so there is no global array to assemble and no
non-addressable shard to fetch.

``resolve_mesh`` makes JAX's decisions for the ``data_parallel`` knob over
a list of devices, each of which may name its ``process_index``: training
resolves over the process group (one device per process,
``process_devices``), serving over the local CUDA devices.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .dist import get_rank, get_world_size

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "ProcessDevice",
    "make_mesh",
    "process_devices",
    "local_devices",
    "shard_batch_size",
    "resolve_mesh",
    "resolve_mesh_from_config",
]

logger = logging.getLogger("tactilesr_torch")

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``size`` places, this process's first at ``rank``.
    ``devices`` lists the devices of a mesh inside one process (serving's
    replicas); a mesh over the process group has none, since each rank
    trains on its own device."""

    size: int
    rank: int = 0
    devices: Tuple[torch.device, ...] = ()

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}


class ProcessDevice(NamedTuple):
    """The device of one rank of the process group."""

    process_index: int


def process_devices() -> list:
    """One entry per rank of the process group (one for a single process)."""
    return [ProcessDevice(r) for r in range(get_world_size())]


def local_devices(device="cuda") -> list:
    """This process's devices of ``device``'s type: every CUDA device, or
    the CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _process_of(d) -> int:
    return getattr(d, "process_index", 0)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``: the process group's when None or when they
    span processes (one device each), else one process's devices, each
    holding a replica."""
    if devices is None:
        return Mesh(get_world_size(), get_rank())
    devices = list(devices)
    procs = sorted({_process_of(d) for d in devices})
    if len(procs) > 1 or isinstance(devices[0], ProcessDevice):
        if len(devices) != len(procs):
            raise ValueError(f"a mesh across processes takes one device per process, got "
                             f"{len(devices)} devices on {len(procs)} processes")
        return Mesh(len(devices), procs.index(get_rank()))
    return Mesh(len(devices), 0, tuple(torch.device(d) for d in devices))


def shard_batch_size(batch_size: int, mesh: Mesh) -> int:
    """Validate that the global batch divides evenly over the data axis."""
    ndata = mesh.size
    assert batch_size % ndata == 0, (
        f"global batch size {batch_size} must be divisible by the data-axis size {ndata}")
    return batch_size // ndata


def resolve_mesh(
    spec: Union[str, int, bool, None] = "auto",
    batch_size: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Optional[Mesh]:
    """Mesh from the ``data_parallel`` knob, JAX's rules over ``devices``
    (default: the process group, one device per process):

    - ``"off"`` / ``0`` / ``1`` / ``None`` / ``False`` (and ``false``, ``no``,
      ``none``): no mesh;
    - ``"auto"`` (and ``True``, ``true``, ``on``, ``yes``): every device,
      shrunk with a warning to the largest count that divides
      ``batch_size``; over several processes only in whole multiples of
      the process count, or it raises;
    - an integer N: exactly N devices, which must be present, divide
      ``batch_size`` and, over several processes, lie evenly on them.
    """
    if devices is None:
        devices = process_devices()
    if spec is True:  # bool before the off-tuple: True == 1 would match it
        spec = "auto"
    if isinstance(spec, str):
        low = spec.strip().lower()
        if low in ("true", "on", "yes"):
            spec = "auto"
        elif low in ("false", "no", "none"):
            spec = "off"
        else:
            spec = low
    if spec is False or spec in (None, "off", "0", "1", 0, 1):
        return None
    n = len(devices)
    # a shrunk mesh must still cover every process, or the processes left
    # out hold no rows and the others wait for them in the first collective
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(_process_of(d), []).append(d)
    nproc = len(by_proc)
    per_proc_cap = min(len(v) for v in by_proc.values())

    def pick(ndata):
        if nproc == 1:
            return list(devices)[:ndata]
        per = ndata // nproc
        return [d for pid in sorted(by_proc) for d in by_proc[pid][:per]]

    if spec == "auto":
        ndata = per_proc_cap * nproc
        if batch_size is not None:
            usable = ndata
            while ndata > 0 and batch_size % ndata:
                ndata -= nproc
            if 0 < ndata < usable:
                logger.warning("data_parallel=auto: batch size %d not divisible by %d devices; "
                               "using a %d-device data axis", batch_size, usable, ndata)
        if ndata <= 1:
            if nproc > 1:
                raise ValueError(
                    f"data_parallel=auto: no multiple of the process count ({nproc}) divides "
                    f"batch size {batch_size}; a multi-process run cannot fall back to "
                    "independent single-device replicas -- pick a divisible batch size")
            return None
        return make_mesh(pick(ndata))
    ndata = int(spec)
    assert 1 <= ndata <= n, f"data_parallel={ndata} requested but only {n} devices are present"
    if nproc > 1 and (ndata % nproc or ndata // nproc > per_proc_cap):
        raise ValueError(
            f"data_parallel={ndata} cannot be laid out evenly over {nproc} processes "
            f"({per_proc_cap} devices each); use a multiple of {nproc} up to "
            f"{per_proc_cap * nproc}")
    if batch_size is not None and ndata > 1:
        assert batch_size % ndata == 0, (
            f"batch size {batch_size} must be divisible by data_parallel={ndata}")
    if ndata == 1:
        return None
    return make_mesh(pick(ndata))


def resolve_mesh_from_config(config) -> Optional[Mesh]:
    """Mesh from a task config's ``data_parallel`` and ``train_batch_size``
    over the process group, with the announcement log."""
    mesh = resolve_mesh(config.get("data_parallel", "auto"), batch_size=config["train_batch_size"])
    if mesh is not None:
        logger.info("Data parallelism: %d-device mesh %s", mesh.size, mesh.shape)
    return mesh
