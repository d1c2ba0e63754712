"""tPSFNet training recipe, stage 1 of the pipeline: learn the PSF physics
(the port of ``tactilesr_tpu/tasks/tpsf_task.py``).

    python -m tactilesr_torch.tasks.tpsf_task [-c cfg.yaml] [--<key> value ...]

takes the flags of ``train/tPSFNet_train.py`` (one per scalar key of
``config.tPSFNet_config``) plus ``--device`` (``cuda`` by default; a run
without a GPU raises unless it passes ``--device cpu``).

Workload parity with the reference entry (train/tPSFNet_train.py): the
inputs are LR/scale_num and the raw depth map; the loss is the MSE between
the degraded prediction and the real z-channel reading over the valid rows;
eval reports MSE and SSIM of the first sample of each test batch, averaged;
an inference hook plots alpha/beta against force over two single-tap press
sequences.  On a GPU the physics of every step runs through the CUDA
kernel's autograd wrapper (``ops/cuda::tpsf_physics_fused``), whose forward
kernel ``physics_precision`` selects: f32 (``highest``) or bf16 tensor-core
products in one pass (``default``) or three (``high``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config.default import tPSFNet_config
from ..data.datasets import SingleTapSeqsDataset, TPSFNetDataset
from ..metrics import batched_ssim
from ..models.tpsf_net import TPSFNet
from ..ops.psf import resolve_use_kernel
from ..parallel.dist import get_rank, init_distributed, is_main_process
from ..parallel.mesh import resolve_mesh_from_config
from ..runtime.checkpoint import load_checkpoint_file
from ..runtime.device import resolve_device
from ..runtime.hooks import EvalHook, HookBase
from ..runtime.logger import setup_logger
from ..runtime.misc import apply_matmul_precision, compute_dtype, set_random_seed
from ..runtime.optim import adam_l2
from ..runtime.schedule import LRWarmupSchedule, StepLR
from ..runtime.trainer import Trainer, eval_forward, masked_mse

__all__ = [
    "TPSFTrainer",
    "build_model",
    "build_eval_fn",
    "InferenceHookTPSF",
    "main",
    "inspect_checkpoint",
]

logger = logging.getLogger("tactilesr_torch")


def build_model(config) -> TPSFNet:
    """A TPSFNet from the config, initialised from ``random_seed``.
    ``physics_precision`` (highest, high or default; typos raise) sets the
    kernel's products; with ``use_pallas_physics: false`` the physics is the
    plain f32 version whatever it says, as JAX's XLA path."""
    return TPSFNet(
        gama=config["gama"],
        perception_scale=config["perception_scale"],
        use_kernel=resolve_use_kernel(config.get("use_pallas_physics", "auto")),
        generator=torch.Generator().manual_seed(int(config["random_seed"])),
        dtype=compute_dtype(config),
        physics_precision=config.get("physics_precision"),
    )


class TPSFTrainer(Trainer):
    def __init__(self, config, model, **kwargs):
        self.config = config
        self.scale_num = config["scale_num"]
        super().__init__(model=model, **kwargs)

    def train_cal_loss(self, batch):
        lr_in = batch["LR"].float() / self.scale_num
        depth = batch["depth"][:, None]  # (B, 1, 100, 100)
        _hr, lr_degrade, _psf, _ab = self.model(lr_in, depth, return_psf=False)
        loss = masked_mse(lr_in[:, 2:3], lr_degrade, batch["mask"])
        return loss, {"total_loss": loss}


def build_eval_fn(trainer: TPSFTrainer, test_arrays: Dict[str, np.ndarray]):
    """MSE and SSIM between the degraded 4x4 prediction and the real
    z-channel for the first sample of every test batch (the final partial
    batch included), averaged over those samples: the reference's eval.
    All first samples run as one batch."""
    config = trainer.config
    bs = config["test_batch_size"]
    scale_num = config["scale_num"]
    firsts = np.arange(0, test_arrays["LR"].shape[0], bs)
    lr_f = torch.from_numpy(np.ascontiguousarray(test_arrays["LR"][firsts])).to(trainer.device)
    depth_f = torch.from_numpy(np.ascontiguousarray(test_arrays["depth"][firsts])).to(trainer.device)

    def eval_func() -> Dict[str, float]:
        lr1 = lr_f.float() / scale_num
        _hr, deg, _psf, _ab = trainer.model_apply(lr1, depth_f[:, None], return_psf=False)
        deg0, lr_z = deg[:, 0], lr1[:, 2]
        mse = ((deg0 - lr_z) ** 2).mean(dim=(-2, -1))
        mse_ave, ssim_ave = torch.stack(
            [mse.mean(), batched_ssim(deg0, lr_z).mean()]).cpu().tolist()
        logger.info("mse_loss_ave:%.6g, ssim_ave:%.6g", mse_ave, ssim_ave)
        return {"Eval Metric": mse_ave, "eval_ssim": ssim_ave}

    return eval_func


class InferenceHookTPSF(HookBase):
    """Per-epoch alpha/beta-vs-force curves over two press sequences, plus
    their depth patterns: the reference's physics-sanity PNG."""

    priority = 5

    def __init__(self, seq_arrays_1, seq_arrays_2, scale_num: int = 100):
        self._seqs = (seq_arrays_1, seq_arrays_2)
        self._scale = scale_num

    def _curves(self, arrays, model):
        """(force, alpha, beta) as numpy arrays for one press sequence."""
        dev = next(model.parameters()).device
        lr = torch.from_numpy(np.ascontiguousarray(arrays["LR"])).to(dev).float() / self._scale
        depth = torch.from_numpy(np.ascontiguousarray(arrays["depth"])).to(dev)[:, None]
        _hr, _deg, _psf, ab = eval_forward(model, lr, depth, return_psf=False)
        ab = ab[:, 0].cpu().numpy()
        force = lr[:, 2].sum(dim=(1, 2)).cpu().numpy()
        return force, ab[:, 0], ab[:, 1]

    def after_epoch(self) -> None:
        t = self.trainer
        out_dir = os.path.join(t.work_dir, "inference_result")
        os.makedirs(out_dir, exist_ok=True)
        self.render(os.path.join(out_dir, f"epoch_{t.cur_epoch}.png"))

    def render(self, save_name: str, model=None) -> None:
        """Render the curves PNG.  Inside training the hook reads the live
        trainer's model; standalone callers (``inspect_checkpoint``) pass one."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.gridspec as gridspec
        import matplotlib.pyplot as plt

        if model is None:
            model = self.trainer.model
        fig = plt.figure(figsize=(10, 6), tight_layout=True)
        gs = gridspec.GridSpec(2, 4)
        ax1 = fig.add_subplot(gs[0:2, 1:4])
        ax2 = ax1.twinx()
        ax3 = fig.add_subplot(gs[0, 0])
        ax4 = fig.add_subplot(gs[1, 0])
        for k, (arrays, color, axd) in enumerate(zip(self._seqs, ("red", "blue"), (ax3, ax4))):
            force, alpha, beta = self._curves(arrays, model)
            ax1.plot(force, alpha, color=color, label=rf"pattern{k+1}_$\alpha$")
            ax2.plot(force, beta, "--", color=color, label=rf"pattern{k+1}_$\beta$")
            axd.imshow(np.asarray(arrays["depth"][-1]))
            axd.set_title(f"pattern{k+1}")
        ax1.set_ylabel(r"$\alpha$")
        ax2.set_ylabel(r"$\beta$")
        ax1.legend(loc="upper left")
        ax2.legend(loc="upper right")
        plt.savefig(save_name)
        plt.close(fig)


def _seq_arrays(config):
    out = []
    for key in ("test_dataset_dir_1", "test_dataset_dir_2"):
        ds = SingleTapSeqsDataset(config[key], [config["inference_index"]],
                                  config["inference_seqs_length"])
        lr_s, depth_s = ds.stacked()
        out.append({"LR": lr_s, "depth": depth_s})
    return out


def main(config=None, mesh=None, max_epochs: Optional[int] = None,
         hooks: Sequence[HookBase] = ()) -> TPSFTrainer:
    """Train from ``config``; ``hooks`` are registered beside the recipe's own.
    The process joins its launch's process group and, with ``mesh`` None,
    trains over the mesh of the config's ``data_parallel``: each rank runs
    the physics (its forward kernel and, once a step, its backward kernel)
    on its own rows, the counterpart of JAX's ``shard_map``."""
    config = dict(config or tPSFNet_config)
    init_distributed(device=config.get("device", "cuda"))
    setup_logger("tactilesr_torch", process_index=get_rank())
    dev = resolve_device(config.get("device", "cuda"))
    set_random_seed(config["random_seed"], config["deterministic"])
    apply_matmul_precision(config)
    if mesh is None:
        mesh = resolve_mesh_from_config(config)

    train_ds = TPSFNetDataset(config["dataset_dir"], sample_cnt=config["sample_cnt"],
                              is_sample_idx=list(range(5, 81)), is_aug_data=config["is_aug_data"])
    test_ds = TPSFNetDataset(config["dataset_dir"], sample_cnt=config["sample_cnt"],
                             is_sample_idx=list(range(0, 5)), is_aug_data=config["is_aug_data"])
    logger.info("train dataset size: %d", len(train_ds))
    logger.info("test dataset size: %d", len(test_ds))
    lr_train, depth_train = train_ds.stacked()
    lr_test, depth_test = test_ds.stacked()

    model = build_model(config).to(dev)
    epochs = max_epochs or config["epochs"]
    lr_schedule = LRWarmupSchedule(
        StepLR(config["lr"], config["lr_scheduler_step_size"], config["lr_scheduler_gamma"]),
        by_epoch=True,
        epoch_len=-(-lr_train.shape[0] // config["train_batch_size"]),
    )
    trainer = TPSFTrainer(
        config=config,
        model=model,
        optimizer=adam_l2(model.parameters(), weight_decay=config["weight_decay"],
                          clip_grad_norm=config.get("clip_grad_norm", 0.0)),
        lr_schedule=lr_schedule,
        train_arrays={"LR": lr_train, "depth": depth_train},
        batch_size=config["train_batch_size"],
        max_epochs=epochs,
        work_dir=config["save_dir"],
        checkpoint_period=config["checkpoint_period"],
        seed=config["random_seed"],
        scan_epochs=bool(config.get("scan_epochs", False)),
        remat=bool(config.get("remat", False)),
        grad_accum=int(config.get("grad_accum", 1)),
        device=dev,
        mesh=mesh,
    )
    trainer.register_hooks([EvalHook(1, build_eval_fn(trainer, {"LR": lr_test, "depth": depth_test}))])

    if config.get("inference_test"):
        missing = [config[k] for k in ("test_dataset_dir_1", "test_dataset_dir_2")
                   if not os.path.exists(config[k])]
        if missing:
            logger.warning("inference dataset %s missing; hook disabled", missing[0])
        elif is_main_process():  # PNG artifacts write once, like checkpoints
            trainer.register_hooks(
                [InferenceHookTPSF(*_seq_arrays(config), scale_num=config["scale_num"])])
    trainer.register_hooks(list(hooks))

    trainer.train(auto_resume=False)
    return trainer


def inspect_checkpoint(config, checkpoint_path: str, save_name: str = "out.png") -> str:
    """Render the alpha/beta-vs-force curves of a trained checkpoint over
    the two configured press sequences, without training (the reference's
    test_tPSF entry, train/tPSFNet_train.py:306-332)."""
    setup_logger("tactilesr_torch")
    config = dict(config or tPSFNet_config)
    model = build_model(config)
    model.load_state_dict(load_checkpoint_file(checkpoint_path)["model"], strict=True)
    model = model.to(resolve_device(config.get("device", "cuda")))
    hook = InferenceHookTPSF(*_seq_arrays(config), scale_num=config["scale_num"])
    hook.render(save_name, model=model)
    logger.info("wrote %s", save_name)
    return save_name


def _cli(argv=None, hooks: Sequence[HookBase] = ()) -> TPSFTrainer:
    from ..config.parser import ConfigArgumentParser, add_config_args, apply_overrides

    parser = ConfigArgumentParser(prog="python -m tactilesr_torch.tasks.tpsf_task",
                                  description="tPSFNet training (stage 1)")
    add_config_args(parser, tPSFNet_config)
    config = apply_overrides(tPSFNet_config, parser.parse_args(argv))
    return main(config, hooks=hooks)


if __name__ == "__main__":
    _cli()
