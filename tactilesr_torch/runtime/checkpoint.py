"""The port's checkpoint bundle: a torch ``.pth`` holding
``{"model": state_dict, "epoch": int, "num_devices": int, ...}``.

This is the shape ``tactilesr_tpu/compat/export_torch.py`` writes for the
reference's model-loading paths, with the state_dict in the reference
layout, so an exported JAX checkpoint is also a port checkpoint.  A training
checkpoint keeps ``"model"`` the same and adds the optimizer, schedule,
metric-storage and hook states beside it, all plain containers of tensors,
numbers and strings, so every bundle loads with ``weights_only=True``.

``load_checkpoint_file`` also reads, as a bundle with ``"model"``:

- the JAX package's flax-msgpack ``.ckpt`` files (any path ending in
  ``.ckpt``), through ``read_ckpt``; the ``model`` tree becomes a
  state_dict through ``compat/from_jax.py``, the architecture told by its
  keys.  Only the weights and the bundle's plain numbers and strings carry
  over: the optax optimizer state (a tree of tuples, stored as dicts keyed
  "0", "1", ...) is read without error and dropped, since nothing maps it
  to torch's Adam state (JAX's own interchange carries model weights only);
- the reference's ``.pth`` forms, as ``tactilesr_tpu/compat/
  torch_convert.py::load_torch_state_dict`` reads them: a bare state_dict,
  ``{'model': state_dict, ...}``, ``{'model': nn.Module}``, a bare pickled
  ``nn.Module``, and the reference trainer's bundle whose
  ``metric_storage`` is a pickled object.  Those that hold pickled Python
  objects load only with ``allow_pickle=True`` (``--allow-pickle`` on the
  CLIs): unpickling runs code named in the file.

``read_ckpt`` and ``write_ckpt`` are flax 0.12's msgpack format
(``flax/serialization.py``) in plain ``msgpack``: arrays are ext records
(code 1: ``packb((shape, dtype name, C-order bytes))``; 2: a complex as
``(real, imag)``; 3: a numpy scalar, packed as an array), an array over
``MAX_CHUNK_SIZE`` bytes is a dict of flat chunks.  ``bfloat16`` has no
numpy type here, so such leaves read as torch bf16 tensors.

``CheckpointManager`` is the directory-level part of
``tactilesr_tpu/runtime/checkpoint.py``: ``epoch_{e}.pth`` files, a
``latest.pth`` symlink and ``max_to_keep`` garbage collection.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import pickle
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch

from ..compat import from_jax

__all__ = [
    "CheckpointManager",
    "LATEST_NAME",
    "jax_arch",
    "load_checkpoint_file",
    "load_state_dict_strict_false",
    "read_ckpt",
    "save_checkpoint_file",
    "write_bundle",
    "write_ckpt",
]

logger = logging.getLogger("tactilesr_torch")

LATEST_NAME = "latest.pth"
CKPT_SUFFIX = ".ckpt"

# flax/serialization.py's ext type codes and chunking
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def write_bundle(path: str, bundle: Dict[str, Any]) -> str:
    """Write a bundle atomically (temp file, then rename), tensors on the CPU."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(bundle), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint_file(path: str, state_dict: dict, epoch: int = 0, **extra) -> str:
    """Write ``{"model": state_dict, "epoch", "num_devices": 1, **extra}``."""
    return write_bundle(path, {"model": state_dict, "epoch": int(epoch), "num_devices": 1, **extra})


def load_checkpoint_file(path: str, allow_pickle: bool = False) -> Dict[str, Any]:
    """Read a bundle onto the CPU: a port ``.pth``, a JAX ``.ckpt`` or one
    of the reference's ``.pth`` forms (module docstring).  Tensors only, no
    pickled code, unless ``allow_pickle``."""
    if str(path).endswith(CKPT_SUFFIX):
        return _bundle_from_ckpt(read_ckpt(path), path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not allow_pickle:
            raise ValueError(
                f"{path!r} holds pickled Python objects, which a weights-only load refuses "
                f"({str(e).splitlines()[0]}); if the file comes from a source you trust, "
                "load it with allow_pickle=True (--allow-pickle on the command line)"
            ) from e
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return _bundle_from_torch(obj, path)


def _is_state_dict(obj) -> bool:
    return isinstance(obj, dict) and bool(obj) and all(
        isinstance(v, torch.Tensor) for v in obj.values())


def _bundle_from_torch(obj, path: str) -> Dict[str, Any]:
    if isinstance(obj, torch.nn.Module):  # torch.save(model, path)
        return {"model": obj.state_dict()}
    if isinstance(obj, dict) and "model" in obj:
        model = obj["model"]
        if isinstance(model, torch.nn.Module):  # torch.save({"model": model, ...})
            return dict(obj, model=model.state_dict())
        if _is_state_dict(model):
            return obj
    elif _is_state_dict(obj):  # a bare state_dict
        return {"model": obj}
    raise ValueError(f"{path!r} is not a checkpoint: no state_dict, no 'model' entry holding one "
                     "and no nn.Module")


# the JAX tree's tell-tale parameter of each architecture -> its bridge
_JAX_ARCHS = {
    "inputContact_layer": ("tactileSR", from_jax.tactile_sr_state_dict),
    "input_zyx_conv0": ("tactileSRCNN", from_jax.tactile_srcnn_state_dict),
    "mlp_0": ("tPSFNet", from_jax.tpsf_net_state_dict),
}


def jax_arch(model: dict) -> Tuple[str, Any]:
    """(architecture name, ``from_jax`` bridge) of a JAX ``{"params",
    "batch_stats"}`` tree, told by its parameter names."""
    params = model.get("params", {}) if isinstance(model, dict) else {}
    for key, found in _JAX_ARCHS.items():
        if key in params:
            return found
    raise ValueError(f"not a TactileSR, TactileSRCNN or tPSFNet parameter tree "
                     f"(top-level parameters {sorted(params)[:8]})")


def _bundle_from_ckpt(tree, path: str) -> Dict[str, Any]:
    if not isinstance(tree, dict) or "model" not in tree:
        raise ValueError(f"{path!r} is not a checkpoint bundle (no 'model' entry)")
    model = tree["model"]
    _, bridge = jax_arch(model)
    sd = bridge({"params": model["params"], "batch_stats": model.get("batch_stats", {})})
    meta = {k: v for k, v in tree.items() if isinstance(v, (bool, int, float, str))}
    return {**meta, "model": sd}


def _array_from_bytes(data: bytes):
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        flat = (torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf
                else torch.empty(0, dtype=torch.bfloat16))
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == EXT_COMPLEX:
        re_, im = msgpack.unpackb(data)
        return complex(re_, im)
    if code == EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    raise ValueError(f"unknown msgpack ext type {code} in a .ckpt (flax uses 1, 2 and 3)")


def _unchunk(obj):
    if isinstance(obj, dict):
        if obj.get(_CHUNKED):
            chunks = [obj["chunks"][str(i)] for i in range(len(obj["chunks"]))]
            shape = tuple(obj["shape"][str(i)] for i in range(len(obj["shape"])))
            cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
            return cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in obj.items()}
    return obj


def read_ckpt(path: str):
    """A flax-msgpack ``.ckpt`` as a tree of dicts, lists, Python scalars,
    numpy arrays and (bf16 leaves) torch tensors."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def _array_bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):  # bf16: numpy has no such type
        raw = arr.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
        return msgpack.packb((tuple(arr.shape), "bfloat16", raw), use_bin_type=True)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no .ckpt form")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return msgpack.ExtType(EXT_NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    return x


def _chunk(arr):
    flat = arr.reshape(-1)
    step = max(1, int(MAX_CHUNK_SIZE / arr.itemsize))
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(obj):
    """Tensors to numpy (bf16 ones stay tensors), oversized arrays chunked."""
    if isinstance(obj, dict):  # keys sorted, as flax's tree_map leaves them
        return {k: _prepare(obj[k]) for k in sorted(obj)}
    if isinstance(obj, list):
        return [_prepare(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu()
        if obj.dtype != torch.bfloat16:
            obj = obj.numpy()
    if isinstance(obj, (np.ndarray, torch.Tensor)) and obj.nbytes > MAX_CHUNK_SIZE:
        return _chunk(obj)
    return obj


def write_ckpt(path: str, tree) -> str:
    """Write ``tree`` (dicts with string keys, lists, Python scalars and
    strings, numpy arrays and scalars, torch tensors) as a flax-msgpack
    ``.ckpt``, atomically; ``flax.serialization.msgpack_restore`` reads it.
    Tuples raise, as in flax."""
    data = msgpack.packb(_prepare(tree), default=_ext_pack, strict_types=True)
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def load_state_dict_strict_false(module: torch.nn.Module,
                                 state_dict: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Load the keys ``module`` and ``state_dict`` share; returns
    (missing, unexpected).  A key whose shape differs is skipped with a
    warning and counted as unexpected (``torch``'s own strict=False load
    raises on it; the JAX package's ``merge_pytree_strict_false`` skips)."""
    current = module.state_dict()
    missing = sorted(set(current) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(current))
    merged = dict(current)
    for k in set(current) & set(state_dict):
        if tuple(current[k].shape) != tuple(state_dict[k].shape):
            logger.warning("Shape mismatch for %s: checkpoint %s vs model %s; skipping",
                           k, tuple(state_dict[k].shape), tuple(current[k].shape))
            unexpected.append(k)
            continue
        merged[k] = state_dict[k]
    module.load_state_dict(merged, strict=True)
    return missing, sorted(unexpected)


class CheckpointManager:
    """Directory-level manager: save bundles, tag latest, GC old files."""

    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        self._saved: List[str] = []
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, file_name: str, bundle: Dict[str, Any]) -> str:
        path = osp.join(self.ckpt_dir, file_name)
        logger.info("Saving checkpoint to %s", path)
        write_bundle(path, bundle)
        latest = osp.join(self.ckpt_dir, LATEST_NAME)
        if osp.lexists(latest):
            os.remove(latest)
        os.symlink(file_name, latest)  # relative: the directory can move
        self._saved.append(file_name)
        if self.max_to_keep is not None and self.max_to_keep > 0:
            while len(self._saved) > self.max_to_keep:
                victim = osp.join(self.ckpt_dir, self._saved.pop(0))
                if osp.exists(victim):
                    os.remove(victim)
        return path

    def latest_path(self) -> Optional[str]:
        p = osp.join(self.ckpt_dir, LATEST_NAME)
        return p if osp.exists(p) else None

    def state_dict(self) -> dict:
        return {"saved": list(self._saved)}

    def load_state_dict(self, state: dict) -> None:
        self._saved = list(state.get("saved", []))
