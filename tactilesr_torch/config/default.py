"""Default configs: plain dicts merged over a common block (the port's copy of
``tactilesr_tpu/config/default.py``'s common and tPSFNet blocks).

The keys and values are the JAX package's, so one YAML file drives both.
The port reads them so:
- ``device`` (added here): where the recipe runs, ``"cuda"`` by default; a
  run without a GPU raises unless it asks for ``"cpu"``;
- ``compute_dtype``: the dtype of the MLP's products (params stay f32);
- ``matmul_precision``: ``highest`` turns TF32 off for f32 CUDA matmuls,
  ``high`` and ``default`` allow it (``runtime/misc.py``);
- ``use_pallas_physics``: ``auto`` or true runs the physics through the
  CUDA kernel's autograd wrapper on CUDA tensors, false through the plain
  version under autograd (``tasks/tpsf_task.py``);
- ``physics_precision``: only ``highest`` (f32 FMA) is ported;
- ``scan_epochs`` and ``remat`` must stay False (not ported);
- ``data_parallel``: the port trains on one device, so only ``auto`` and
  the off values are accepted (``parallel/dist.py::check_single_device``).
"""

from __future__ import annotations

import os

__all__ = ["common_config", "tPSFNet_config", "root_path"]

root_path = os.environ.get("TACTILESR_ROOT", os.getcwd())

common_config = {
    "root_path": root_path,
    "random_seed": 42,
    "deterministic": False,
    "scale_num": 100,  # raw taxel readings are divided by this
    "compute_dtype": "bfloat16",
    "scan_epochs": False,
    "remat": False,
    # split each optimizer step's batch into K micro-batches, accumulate
    # valid-row-weighted gradients, step once; 1 = off
    "grad_accum": 1,
    "data_parallel": "auto",
    "matmul_precision": "default",
    "device": "cuda",
}

# ---------------------------------------------------------------- tPSFNet
tPSFNet_config = {
    **common_config,
    "train_batch_size": 256,
    "test_batch_size": 8,
    "gama": 1.4,
    "perception_scale": None,
    "loss_scale": 1e-1,
    "lr": 1e-4,
    "lr_scheduler_step_size": 1,
    "lr_scheduler_gamma": 0.8,
    "checkpoint_period": 1,
    "weight_decay": 1e-5,
    "epochs": 51,
    "sample_cnt": 32,
    "dataset_dir": os.path.join(root_path, "data/rotateDataset"),
    "save_dir": os.path.join(root_path, "pth/tPSFNet_no_aug"),
    "is_aug_data": False,
    "use_pallas_physics": "auto",
    "physics_precision": "highest",
    # inference-test params (alpha/beta-vs-force curves)
    "inference_test": True,
    "inference_index": 36,
    "inference_seqs_length": 64,
    "test_dataset_dir_1": os.path.join(root_path, "data/rotateDataset/I.npy"),
    "test_dataset_dir_2": os.path.join(root_path, "data/rotateDataset/P.npy"),
}
