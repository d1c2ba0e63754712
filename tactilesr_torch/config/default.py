"""Default configs: plain dicts merged over a common block (the port's copy of
``tactilesr_tpu/config/default.py``: common, tPSFNet, tactileSR and
tactileSeqs).

The keys and values are the JAX package's, so one YAML file drives both.
The port reads them so:
- ``device`` (added here): where the recipe runs, ``"cuda"`` by default; a
  run without a GPU raises unless it asks for ``"cpu"``;
- ``compute_dtype``: the dtype of the MLP's products (params stay f32);
- ``matmul_precision``: ``highest`` turns TF32 off for f32 CUDA matmuls
  and cuDNN convolutions, ``high`` and ``default`` allow it (``runtime/misc.py``);
- ``use_pallas_physics``: ``auto`` or true runs the physics through the
  CUDA kernel's autograd wrapper on CUDA tensors, false through the plain
  version under autograd (``tasks/tpsf_task.py``);
- ``physics_precision``: the products of the physics' forward kernel, all
  three modes ported: ``highest`` f32 FMA, ``default`` bf16 tensor-core
  products with f32 sums (one pass), ``high`` three bf16 passes
  (``ops/psf.py``); ignored, as in JAX, when ``use_pallas_physics`` is
  false, and the backward is f32 whatever it says;
- ``scan_epochs``: each epoch as replays of one CUDA-graph-captured train
  step on a GPU (the same step uncaptured on the CPU); ``remat``:
  activation checkpointing of the forward and loss
  (``runtime/trainer.py``);
- ``model_arch``: ``TactileSR`` or ``TactileSRCNN`` (single-frame,
  ``tasks/sr_task.py``);
- ``load_checkpoint_dir`` (tactileSeqs): a port ``.pth`` bundle of the
  trained STSR, whose trunk warm-starts the MTSR;
- ``data_parallel``: data parallelism over the process group, one process
  per device (``parallel/mesh.py``): ``auto`` uses every rank the batch
  size divides over (one process: no mesh), ``off`` disables, an integer
  requests exactly N devices.  The ranks come from the launch
  (``parallel/dist.py::init_distributed``: ``TACTILESR_*``, ``env://`` or
  SLURM).
"""

from __future__ import annotations

import os

__all__ = ["common_config", "tPSFNet_config", "tactileSR_config", "tactileSeqs_config", "root_path"]

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

# --------------------------------------------------------------- tactileSR
tactileSR_config = {
    **common_config,
    "train_batch_size": 32,
    "test_batch_size": 8,
    "lr": 1e-3,
    "weight_decay": 1e-2,
    "lr_scheduler_step_size": 2,
    "lr_scheduler_gamma": 0.8,
    "checkpoint_period": 1,
    "HR_scale_num": 10,
    # PSNR max value; the code passes this value itself (not /HR_scale_num)
    "sensorMaxVaule_factor": 250,
    "epochs": 51,
    "warmup_t": 2000,
    # the reference entry never forwards warmup_by_epoch (so it is False in
    # effect); the key stays for schema parity
    "warmup_by_epoch": True,
    "warmup_mode": "auto",
    "warmup_init_lr": 1e-5,
    "warmup_factor": 1e-4,
    "scale_factor": 10,
    "seqsCnt": 1,
    "axisCnt": 3,
    "patternFeatureExtraLayerCnt": 6,
    "forceFeatureExtraLayerCnt": 1,
    "model_arch": "TactileSR",
    # "reference": Kaiming fan_out on the final conv->ReLU head;
    # "non_negative": |Kaiming| / sqrt(fan_in) on that one kernel
    "head_init": "reference",
    # detector of the born-dead head (loss pinned at mean(HR^2), ~zero
    # output variance); "warn" logs once, "reinit" re-draws the head kernel
    "dead_head_check": True,
    "dead_head_action": "warn",
    "inference_test": True,
    "save_dir": os.path.join(root_path, "pth/tactileSR_single"),
    "train_dataset_dir": os.path.join(root_path, "data/SRdataset/SRdataset_train.npz"),
    "test_dataset_dir": os.path.join(root_path, "data/SRdataset/SRdataset_test.npz"),
    "val_dataset_dir": os.path.join(root_path, "data/SRdataset/SRdataset_validation.npz"),
}

# ------------------------------------------------------------- tactileSeqs
tactileSeqs_config = {
    **tactileSR_config,
    "seqsCnt": 7,  # seqs length <= 7
    "axisCnt": 3,
    "lr": 1e-4,
    "weight_decay": 1e-2,
    "epochs": 51,
    "load_checkpoint_dir": os.path.join(root_path, "pth/tactileSR_single/checkpoints/epoch_50.pth"),
    # opt-in LR warmup for the seqs stage (the reference entry wires none)
    "seqs_use_warmup": False,
    "save_dir": os.path.join(root_path, "pth/tactileSeqs_seq_7"),
    "train_dataset_dir": os.path.join(root_path, "data/SeqsDataset/SRdataset_train_32.npz"),
    "test_dataset_dir": os.path.join(root_path, "data/SeqsDataset/SRdataset_test_32.npz"),
    "val_dataset_dir": os.path.join(root_path, "data/SeqsDataset/SRdataset_validation_32.npz"),
}
