"""Process-group helpers (the port of ``tactilesr_tpu/parallel/dist.py``).

The JAX package runs one controller per host over every device of a mesh;
the port runs one process per device, joined in a ``torch.distributed``
process group.  ``init_distributed`` makes that group from the launch
environment (a no-op for one process); rank, world size and
``is_main_process`` gate checkpoints, TensorBoard and PNGs to rank 0;
``reduce_dict``, ``all_gather_object`` and ``gather_object`` are the
reference's host-side reductions (cpu/distributed.py).  Without a group the
process is rank 0 of a world of 1 and every helper is the identity.
``spawn_local_ranks`` and ``rank_results`` start the ranks of one program
on this host and collect what each reports.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "init_distributed",
    "get_rank",
    "get_world_size",
    "is_main_process",
    "reduce_dict",
    "all_gather_object",
    "gather_object",
    "spawn_local_ranks",
    "rank_results",
]

logger = logging.getLogger("tactilesr_torch")

# a peer that never joins (or a collective that never completes) fails the
# run after this long instead of hanging it
DIST_TIMEOUT = datetime.timedelta(seconds=300)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _launch(coordinator_address, num_processes, process_id):
    """(init_method, world, rank, local_rank) of the launch, or None for one
    process: explicit arguments, then ``TACTILESR_*``, then torch's
    ``env://`` variables, then SLURM."""
    env = os.environ
    if num_processes is None and env.get("TACTILESR_NUM_PROCESSES"):
        coordinator_address = coordinator_address or env.get("TACTILESR_COORDINATOR")
        num_processes = int(env["TACTILESR_NUM_PROCESSES"])
        if process_id is None and env.get("TACTILESR_PROCESS_ID"):
            process_id = int(env["TACTILESR_PROCESS_ID"])
    if num_processes is not None:
        if num_processes <= 1:
            return None
        if coordinator_address is None or process_id is None:
            raise ValueError(f"a {num_processes}-process launch needs a coordinator address "
                             "(host:port) and this process's id")
        local = int(env.get("LOCAL_RANK", process_id))
        return f"tcp://{coordinator_address}", num_processes, process_id, local
    if int(env.get("WORLD_SIZE", "1")) > 1:  # torch's launchers (torchrun)
        rank = int(env["RANK"])
        return "env://", int(env["WORLD_SIZE"]), rank, int(env.get("LOCAL_RANK", rank))
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        if not env.get("MASTER_ADDR"):
            raise ValueError("a SLURM launch needs MASTER_ADDR (and MASTER_PORT) to name rank 0's host")
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        return (f"tcp://{addr}", int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]),
                int(env.get("SLURM_LOCALID", env["SLURM_PROCID"])))
    return None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> int:
    """Join the process group of this launch and return this process's rank
    (0, and no group, for a single process).  Idempotent.

    The launch comes from, in order: the arguments (``coordinator_address``
    is ``host:port``); ``TACTILESR_COORDINATOR`` / ``TACTILESR_NUM_PROCESSES``
    / ``TACTILESR_PROCESS_ID``; torch's ``env://`` variables (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); a SLURM allocation
    (``SLURM_NTASKS`` > 1, rank 0's host in ``MASTER_ADDR``).  The backend is
    ``backend``, else ``TACTILESR_BACKEND``, else ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU.  On CUDA the process's device is
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``, else
    ``SLURM_LOCALID``, else the rank).  NCCL refuses two ranks on one card;
    gloo with CUDA tensors takes them, copying each collective through the
    host, and is a test path only."""
    if _initialized():
        return dist.get_rank()
    launch = _launch(coordinator_address, num_processes, process_id)
    if launch is None:
        return 0
    init_method, world, rank, local = launch
    from ..runtime.device import resolve_device

    dev = resolve_device(device)
    backend = backend or os.environ.get("TACTILESR_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=DIST_TIMEOUT)
    logger.info("torch.distributed initialized: rank %d / %d (%s)", rank, world, backend)
    return rank


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def _comm_device() -> torch.device:
    """Where a tensor for a host-side collective lives: NCCL takes only
    CUDA tensors, gloo the CPU's."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(metrics: Dict[str, Any], average: bool = True) -> Dict[str, float]:
    """Average (or sum) a dict of scalars over the processes; every process
    must pass the same keys.  One process: the floats unchanged."""
    if get_world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                       device=_comm_device())
    dist.all_reduce(vec)
    if average:
        vec /= get_world_size()
    return dict(zip(keys, vec.cpu().tolist()))


def all_gather_object(value: Any) -> list:
    """Every process's picklable ``value``, in rank order, on every process."""
    if get_world_size() == 1:
        return [value]
    out = [None] * get_world_size()
    dist.all_gather_object(out, value)
    return out


def gather_object(value: Any, dst: int = 0) -> Optional[list]:
    """The rooted gather: the list of every process's ``value`` on ``dst``,
    None elsewhere."""
    gathered = all_gather_object(value)
    return gathered if get_rank() == dst else None


def spawn_local_ranks(argv: Sequence[str], n: int, backend: Optional[str] = None,
                      env: Optional[Dict[str, str]] = None) -> List[subprocess.Popen]:
    """Start ``n`` processes of ``argv`` on this host, one a rank, joined
    through the ``TACTILESR_*`` variables on a free loopback port
    (``TACTILESR_BACKEND`` set when ``backend`` is named), each with
    ``env`` over this process's environment.  Each rank's output goes to a
    temporary file (its ``out`` attribute) that ``rank_results`` reads."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {**os.environ, **(env or {}), "TACTILESR_COORDINATOR": f"127.0.0.1:{port}",
            "TACTILESR_NUM_PROCESSES": str(n)}
    if backend:
        base["TACTILESR_BACKEND"] = backend
    procs = []
    for r in range(n):
        out = tempfile.TemporaryFile("w+")
        p = subprocess.Popen(list(argv), env=dict(base, TACTILESR_PROCESS_ID=str(r)), stdout=out,
                             stderr=subprocess.STDOUT, text=True)
        p.out = out
        procs.append(p)
    return procs


def rank_results(procs: Sequence[subprocess.Popen], timeout: float) -> Dict[int, dict]:
    """Wait for every rank of ``spawn_local_ranks`` and return, by rank, the
    JSON of the last ``RESULT {...}`` line each printed.  The first rank to
    fail (or ``timeout`` seconds) ends the wait: the ranks still running are
    killed, since they would wait for the failed one in a collective, and
    the error carries each failed rank's output."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results, failures = {}, []
    for r, p in enumerate(procs):
        p.out.seek(0)
        text = p.out.read()
        p.out.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            failures.append(f"rank {r} exited {p.returncode}:\n{text[-6000:]}")
        else:
            results[r] = json.loads(lines[-1][len("RESULT "):])
    if failures:
        raise RuntimeError("\n".join(failures))
    return results
