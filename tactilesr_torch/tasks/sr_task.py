"""TactileSR training recipe, stage 3 of the pipeline: STSR and MTSR (the
port of ``tactilesr_tpu/tasks/sr_task.py``).

    python -m tactilesr_torch.tasks.sr_task [-c cfg.yaml] [--<key> value ...]
    python -m tactilesr_torch.tasks.sr_seqs_task [-c cfg.yaml] [--<key> value ...]

take the flags of ``train/tactileSR_train.py`` and
``train/tactileSRSeqs_train.py`` (one per scalar key of
``config.tactileSR_config`` / ``config.tactileSeqs_config``) plus
``--device`` (``cuda`` by default; a run without a GPU raises unless it
passes ``--device cpu``).

Workload parity with the reference entries: labels are HR/HR_scale_num,
bilinearly resized from 100 to 4*scale (done once, at dataset build); the
inputs are the first seqsCnt*axisCnt channels; the loss is the MSE over the
valid rows; eval computes per-sample PSNR (max value sensorMaxVaule_factor)
and global SSIM, averaged over the valid rows of each test batch and then
over batches, and MSE per batch; an inference hook renders an LR/HR/SR PNG
per epoch; the seqs variant warm-starts its trunk from the single-frame
checkpoint and gets no warmup unless ``seqs_use_warmup``.  A dead-head
detector watches for the born-dead final ReLU head.  ``model_arch:
TactileSRCNN`` trains the IROS-2022 baseline through the same recipe
(single-frame only), and ``scan_epochs``/``remat`` are the trainer's.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config.default import tactileSeqs_config, tactileSR_config
from ..data.datasets import TactileSRDataset, TactileSRDatasetSeq
from ..metrics import batched_psnr, batched_ssim, psnr, ssim
from ..models.layers import non_negative_kaiming_fan_out_
from ..models.tactile_sr import TactileSR, TactileSRCNN
from ..ops.resize import bilinear_resize_matrix
from ..parallel import dist
from ..parallel.mesh import resolve_mesh_from_config
from ..runtime.checkpoint import load_checkpoint_file
from ..runtime.device import resolve_device
from ..runtime.hooks import EvalHook, HookBase
from ..runtime.logger import setup_logger
from ..runtime.misc import apply_matmul_precision, compute_dtype, set_random_seed
from ..runtime.optim import adam_l2
from ..runtime.schedule import LRWarmupSchedule, StepLR
from ..runtime.trainer import Trainer, masked_mse

__all__ = [
    "SRTrainer",
    "build_model",
    "build_trainer",
    "prepare_sr_labels",
    "build_eval_fn",
    "InferenceHookSR",
    "DeadHeadHook",
    "transfer_trunk_params",
    "main",
    "HEAD_MODULE",
    "CNN_HEAD_MODULE",
    "TRUNK_PREFIXES",
]

logger = logging.getLogger("tactilesr_torch")

HEAD_MODULE = "output_layer.2"  # the final bias-free conv before the last ReLU
CNN_HEAD_MODULE = "output.0"  # TactileSRCNN's
TRUNK_PREFIXES = ("patternFeatureExtra_layer.", "forceFeatureExtra_layer.")
EVAL_CHUNK = 1024  # rows per eval forward; the per-batch grouping is done after


def build_model(config):
    """The SR network of the config, initialised from ``random_seed``:
    ``model_arch`` ``TactileSR`` (the default) or ``TactileSRCNN``, the
    IROS-2022 single-frame baseline (its 6 MSRBs fixed, as in the JAX
    package; ``seqsCnt`` must be 1)."""
    arch = config.get("model_arch", "TactileSR")
    generator = torch.Generator().manual_seed(int(config["random_seed"]))
    if arch == "TactileSRCNN":
        if config["seqsCnt"] != 1:  # ValueError (not assert): survives -O
            raise ValueError(f"TactileSRCNN is single-frame; got seqsCnt={config['seqsCnt']}")
        return TactileSRCNN(scale_factor=config["scale_factor"], axis_cnt=config["axisCnt"],
                            dtype=compute_dtype(config), generator=generator,
                            head_init=config.get("head_init", "reference"))
    if arch != "TactileSR":
        raise ValueError(f"model_arch={arch!r}: expected TactileSR or TactileSRCNN")
    return TactileSR(
        scale_factor=config["scale_factor"],
        seqs_cnt=config["seqsCnt"],
        axis_cnt=config["axisCnt"],
        pattern_feature_extra_layer_cnt=config["patternFeatureExtraLayerCnt"],
        force_feature_extra_layer_cnt=config["forceFeatureExtraLayerCnt"],
        dtype=compute_dtype(config),
        generator=generator,
        head_init=config.get("head_init", "reference"),
    )


def prepare_sr_labels(hr_raw: np.ndarray, config) -> np.ndarray:
    """HR labels as the loss reads them: HR/HR_scale_num, torch-bilinear
    resized to (4*scale)^2 (run once, at dataset build)."""
    hw = 4 * config["scale_factor"]
    hr = hr_raw.astype(np.float32) / config["HR_scale_num"]
    if hr.shape[-2:] == (hw, hw):
        return hr
    wh = bilinear_resize_matrix(hr.shape[-2], hw)
    ww = bilinear_resize_matrix(hr.shape[-1], hw)
    return np.matmul(np.matmul(wh, hr), ww.T).astype(np.float32)


class SRTrainer(Trainer):
    """Trainer with the tactileSR loss: MSE(model(LR), resize(HR/scale))."""

    def __init__(self, config, model, **kwargs):
        self.config = config
        arrays = dict(kwargs.pop("train_arrays"))
        arrays["LR"] = arrays["LR"][:, : config["seqsCnt"] * config["axisCnt"]]
        arrays["HR"] = prepare_sr_labels(arrays["HR"], config)
        super().__init__(model=model, train_arrays=arrays, **kwargs)

    def train_cal_loss(self, batch):
        loss = masked_mse(self.model(batch["LR"]), batch["HR"], batch["mask"])
        return loss, {"total_loss": loss}


def build_eval_fn(trainer: SRTrainer, test_arrays: Dict[str, np.ndarray]):
    """The reference's test-set evaluation: per-sample PSNR and SSIM
    averaged over the valid rows of each ``test_batch_size`` batch, MSE per
    batch over its valid rows, then each batch mean averaged over batches.
    Eval mode makes every row independent of its batch, so the set runs in
    chunks of ``EVAL_CHUNK`` rows and is grouped by batch afterwards; the
    final partial batch averages over its valid rows only.

    Under the trainer's mesh each rank evaluates its contiguous block of
    rows of every test batch (JAX shards each batch over the data axis) and
    the per-sample rows are all-gathered, as one ``all_reduce`` of a buffer
    in which each rank fills its own rows, before the grouping: the metrics
    are the same on every rank.  A test batch that does not divide over the
    data axis is evaluated whole on every rank, with JAX's warning."""
    config = trainer.config
    bs = config["test_batch_size"]
    max_value = float(config["sensorMaxVaule_factor"])
    c = config["seqsCnt"] * config["axisCnt"]
    n = test_arrays["LR"].shape[0]
    rows = np.arange(n)
    mesh = trainer.mesh
    if mesh is not None:
        if bs % mesh.size == 0:
            rows = rows[(rows % bs) // (bs // mesh.size) == mesh.rank]
        else:
            logger.warning("test_batch_size %d not divisible by the %d-device data axis; "
                           "evaluation runs unsharded (replicated over the mesh)", bs, mesh.size)
            mesh = None
    lr = torch.from_numpy(np.ascontiguousarray(test_arrays["LR"][rows, :c])).to(trainer.device)
    hr = torch.from_numpy(prepare_sr_labels(test_arrays["HR"][rows], config)).to(trainer.device)
    own = torch.from_numpy(rows).to(trainer.device)
    nb = -(-n // bs)
    batch_of = torch.arange(n, device=trainer.device) // bs
    counts = torch.bincount(batch_of, minlength=nb).float()

    def eval_func() -> Dict[str, float]:
        out = torch.cat([trainer.model_apply(lr[i:i + EVAL_CHUNK])
                         for i in range(0, lr.shape[0], EVAL_CHUNK)])
        per_sample = torch.stack([
            ((out - hr) ** 2).mean(dim=(1, 2, 3)),
            batched_psnr(out[:, 0], hr[:, 0], max_value),
            batched_ssim(out[:, 0], hr[:, 0]),
        ], dim=1)  # (rows, 3)
        if mesh is not None:
            every = torch.zeros(n, 3, device=out.device).index_copy_(0, own, per_sample)
            torch.distributed.all_reduce(every)
            per_sample = every
        sums = torch.zeros(nb, 3, device=out.device).index_add_(0, batch_of, per_sample)
        mse, psnr_v, ssim_v = (sums / counts[:, None]).mean(dim=0).cpu().tolist()
        logger.info("==> [test] loss: %.4f, SSIM: %.4f, PSNR: %.4f", mse, ssim_v, psnr_v)
        return {"test_loss": mse, "test_SSIM": ssim_v, "test_PSNR": psnr_v}

    return eval_func


class InferenceHookSR(HookBase):
    """Per-epoch PNG of (LR_z, HR surface, SR surface) for test sample 0,
    titled with its PSNR/SSIM: the reference's visual-regression artifact."""

    priority = 5

    def __init__(self, test_arrays: Dict[str, np.ndarray], config):
        self._arrays = test_arrays
        self._config = config

    def after_epoch(self) -> None:
        t = self.trainer
        out_dir = os.path.join(t.work_dir, "inference_result")
        os.makedirs(out_dir, exist_ok=True)
        self.render(os.path.join(out_dir, f"epoch_{t.cur_epoch}.png"))

    def render(self, save_name: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = self.trainer
        cfg = self._config
        hw = 4 * cfg["scale_factor"]
        lr = torch.from_numpy(np.ascontiguousarray(
            self._arrays["LR"][:1, : cfg["seqsCnt"] * cfg["axisCnt"]])).to(t.device)
        hr = torch.from_numpy(prepare_sr_labels(self._arrays["HR"][:1], cfg))
        out = t.model_apply(lr).cpu()
        p = float(psnr(out[0, 0], hr[0, 0], float(cfg["sensorMaxVaule_factor"])))
        s = float(ssim(out[0, 0], hr[0, 0]))

        fig = plt.figure(tight_layout=True)
        ax1 = fig.add_subplot(131)
        ax2 = fig.add_subplot(132, projection="3d")
        ax3 = fig.add_subplot(133, projection="3d")
        xg, yg = np.meshgrid(np.arange(hw), np.arange(hw))
        ax1.imshow(lr[0, 2].cpu().numpy(), vmin=0, vmax=8)
        ax2.plot_surface(xg, yg, hr[0, 0].numpy(), vmin=0, vmax=25, cmap="rainbow")
        ax3.plot_surface(xg, yg, out[0, 0].numpy(), vmin=0, vmax=25, cmap="rainbow")
        for ax in (ax2, ax3):
            ax.set_zlim([0, 50])
            ax.view_init(elev=60, azim=-90)
        for ax in (ax1, ax2, ax3):
            ax.axis("off")
        ax1.set_title("LR_z")
        ax2.set_title("HR_img")
        ax3.set_title(f"SR_img {p:.2f}dB {s:.3f}")
        plt.savefig(save_name)
        plt.close(fig)


class DeadHeadHook(HookBase):
    """Detector (and optional in-run cure) of the born-dead head.

    An unlucky draw of the final conv -> ReLU head leaves every output pixel
    in the ReLU's dead half: the model emits a constant map, the loss sits
    at mean(HR^2) and no gradient reaches anything.  The signature: the
    epoch's train loss within ``rel_tol`` of mean(HR^2) and ~zero output
    variance on an eval-mode probe batch.  After ``patience`` such epochs:

    - ``action="warn"``: one warning naming the cure (``head_init:
      non_negative``); the run goes on.
    - ``action="reinit"``: re-draw only the head kernel (``head_module``)
      with ``non_negative_kaiming_fan_out_`` from a generator seeded by
      (``reinit_seed``, the current iteration), zero that parameter's Adam
      moments and keep training.  Once per run; a second death gets the
      warning.  In a multi-process world the hook (rank 0 only) falls back
      to the warning, since an edit on one rank would desynchronise them.

    ``probe_lr`` must already be sliced to the model's input channels; a
    probe forward that fails disables the detector and never kills the run.
    """

    priority = 4

    _ACTIONS = ("warn", "reinit")

    def __init__(self, probe_lr: np.ndarray, patience: int = 3, rel_tol: float = 0.05,
                 n_probe: int = 8, action: str = "warn", head_module: str = HEAD_MODULE,
                 reinit_seed: int = 0):
        if action not in self._ACTIONS:
            raise ValueError(f"dead_head_action must be one of {self._ACTIONS}, got {action!r}")
        self._probe = np.asarray(probe_lr[:n_probe], np.float32)
        self._patience = patience
        self._rel_tol = rel_tol
        self._action = action
        self._head = head_module
        self._reinit_seed = reinit_seed
        self._streak = 0
        self._warned = False
        self._reinited = False
        self._disabled = False

    def before_train(self) -> None:
        # the level the loss pins at, over the prepared labels the loss reads
        hr = self.trainer.device_arrays["HR"]
        self._hr_power, self._hr_var = torch.stack(
            [hr.square().mean(), hr.var(unbiased=False)]).cpu().tolist()

    def after_epoch(self) -> None:
        if self._warned or self._disabled:
            return
        t = self.trainer
        storage = t.metric_storage
        if "total_loss" not in storage:
            return
        loss = storage["total_loss"].avg
        pinned = self._hr_power > 0 and abs(loss - self._hr_power) / self._hr_power < self._rel_tol
        if not pinned:
            self._streak = 0
            return
        try:
            out = t.model_apply(torch.from_numpy(self._probe).to(t.device)).cpu().numpy()
        except Exception:
            # a detector must never kill the run it protects
            self._disabled = True
            logger.warning("DeadHeadHook probe forward failed; disabling the detector "
                           "for this run", exc_info=True)
            return
        flat = np.var(out) < 1e-4 * max(self._hr_var, 1e-12)
        self._streak = self._streak + 1 if flat else 0
        if self._streak < self._patience:
            return
        if self._action == "reinit" and not self._reinited and self._can_reinit():
            self._reinit_head(loss)
            self._streak = 0  # keep watching the revived head
            return
        self._warned = True
        logger.warning(
            "Dead head detected: for %d consecutive epochs the train loss has sat at "
            "mean(HR^2)=%.4g (loss=%.4g) with ~zero output variance (%.3g) on an eval "
            "probe -- the model is emitting a constant map and will not recover.  %s",
            self._patience, self._hr_power, loss, float(np.var(out)),
            "An in-run reinit was already applied and the head died again; restart "
            "with `head_init: non_negative`."
            if self._reinited
            else "Set `dead_head_action: reinit` to revive it in place, or restart with "
            "`head_init: non_negative` (scale-compensated all-positive final kernel), "
            "e.g. `--head_init non_negative`.",
        )

    def _can_reinit(self) -> bool:
        if dist.get_world_size() > 1:
            logger.warning("DeadHeadHook: action=reinit is not supported under a "
                           "multi-process mesh (the hook runs on process 0 only); "
                           "falling back to the warning")
            return False
        return True

    def _reinit_head(self, pinned_loss: float) -> None:
        """Swap the dead head kernel for a fresh non-negative draw and zero
        its Adam moments, in place."""
        t = self.trainer
        weight = getattr(dict(t.model.named_modules()).get(self._head), "weight", None)
        if weight is None:
            self._disabled = True
            logger.warning("DeadHeadHook: no %r weight found in the model; cannot reinit -- "
                           "disabling the detector", self._head)
            return
        seed = int(np.random.SeedSequence([self._reinit_seed, t.cur_iter]).generate_state(1)[0])
        fresh = non_negative_kaiming_fan_out_(torch.empty(weight.shape), torch.Generator().manual_seed(seed))
        with torch.no_grad():
            weight.copy_(fresh)
        for name in ("exp_avg", "exp_avg_sq"):
            moment = t.optimizer.optimizer.state.get(weight, {}).get(name)
            if moment is not None:
                moment.zero_()
        self._reinited = True
        logger.warning(
            "Dead head detected at epoch %d (loss pinned at mean(HR^2)=%.4g for %d epochs, "
            "~zero probe variance) -- dead_head_action=reinit: re-drew the %r kernel %s with "
            "the scale-compensated non-negative init and zeroed its Adam moments; training "
            "continues on the surviving trunk.",
            t.cur_epoch, pinned_loss, self._patience, self._head, tuple(weight.shape),
        )

    def state_dict(self) -> dict:
        return {"streak": self._streak, "warned": self._warned, "reinited": self._reinited}

    def load_state_dict(self, state: dict) -> None:
        self._streak = int(state.get("streak", 0))
        self._warned = bool(state.get("warned", False))
        self._reinited = bool(state.get("reinited", False))


def transfer_trunk_params(seqs_state: dict, single_bundle: dict) -> dict:
    """Warm-start the MTSR trunk from an STSR checkpoint bundle: a copy of
    ``seqs_state`` with every ``patternFeatureExtra_layer.*`` and
    ``forceFeatureExtra_layer.*`` entry (parameters and BN buffers) taken
    from the bundle's model."""
    out = dict(seqs_state)
    moved = {k: v for k, v in single_bundle["model"].items() if k.startswith(TRUNK_PREFIXES)}
    out.update(moved)
    modules = {".".join(k.split(".")[:2]) for k in moved}
    logger.info("Transferred %d trunk modules (%d tensors) from the STSR checkpoint",
                len(modules), len(moved))
    return out


def build_trainer(config, model, train_arrays: Dict[str, np.ndarray], *, seqs: bool, mesh=None,
                  max_epochs: Optional[int] = None) -> SRTrainer:
    """The recipe's trainer of ``model`` over ``train_arrays`` (``LR`` and
    ``HR`` rows) on the config's ``device``.  With ``seqs`` (the MTSR) the
    trunk is first warm-started from the STSR bundle at
    ``load_checkpoint_dir`` (``transfer_trunk_params``; a missing file
    warns and trains from scratch) and the warm-up is off unless
    ``seqs_use_warmup``, as the reference's seqs entry wires none.  The
    StepLR schedule runs by epoch over ``ceil(N / train_batch_size)``
    steps; ``adam_l2`` with ``weight_decay`` and ``clip_grad_norm``;
    ``max_epochs`` or ``epochs``, ``scan_epochs``, ``remat``,
    ``grad_accum``, checkpoints into ``save_dir``; no hook beyond the
    trainer's defaults.  ``mesh`` None trains on this process's device
    alone."""
    dev = resolve_device(config.get("device", "cuda"))
    if seqs:
        if config.get("model_arch", "TactileSR") == "TactileSRCNN":
            raise ValueError("the MTSR trunk transfer is TactileSR's; model_arch=TactileSRCNN has "
                             "no pattern or force trunk")
        src = config.get("load_checkpoint_dir")
        if src and os.path.exists(src):
            model.load_state_dict(
                transfer_trunk_params(model.state_dict(), load_checkpoint_file(src)), strict=True)
        else:
            logger.warning("seqs transfer checkpoint not found at %s; training from scratch", src)

    # the reference's seqs entry wires no warmup; seqs_use_warmup opts in
    use_warmup = not seqs or config.get("seqs_use_warmup", False)
    lr_schedule = LRWarmupSchedule(
        StepLR(config["lr"], config["lr_scheduler_step_size"], config["lr_scheduler_gamma"]),
        by_epoch=True,
        epoch_len=-(-train_arrays["LR"].shape[0] // config["train_batch_size"]),
        warmup_t=config.get("warmup_t", 0) if use_warmup else 0,
        warmup_mode=config.get("warmup_mode", "fix"),
        warmup_init_lr=config.get("warmup_init_lr"),
        warmup_factor=config.get("warmup_factor"),
    )
    return SRTrainer(
        config=config,
        model=model,
        optimizer=adam_l2(model.parameters(), weight_decay=config["weight_decay"],
                          clip_grad_norm=config.get("clip_grad_norm", 0.0)),
        lr_schedule=lr_schedule,
        train_arrays=train_arrays,
        batch_size=config["train_batch_size"],
        max_epochs=max_epochs or config["epochs"],
        work_dir=config["save_dir"],
        checkpoint_period=config["checkpoint_period"],
        seed=config["random_seed"],
        scan_epochs=bool(config.get("scan_epochs", False)),
        remat=bool(config.get("remat", False)),
        grad_accum=int(config.get("grad_accum", 1)),
        device=dev,
        mesh=mesh,
    )


def main(config=None, seqs: bool = False, mesh=None, max_epochs: Optional[int] = None,
         auto_resume: bool = False, hooks: Sequence[HookBase] = ()) -> SRTrainer:
    """Train the SR network of ``config`` (STSR, or TactileSRCNN with
    ``model_arch``; ``seqs=True`` trains the MTSR on the SeqsDataset with
    the trunk transfer).  The process joins its launch's process group
    (``parallel.init_distributed``) and, with ``mesh`` None, trains over
    the mesh of the config's ``data_parallel``.  ``auto_resume`` continues
    from ``latest.pth`` in the work dir; ``hooks`` are registered beside the
    recipe's own."""
    config = dict(config or (tactileSeqs_config if seqs else tactileSR_config))
    dist.init_distributed(device=config.get("device", "cuda"))
    setup_logger("tactilesr_torch", process_index=dist.get_rank())
    set_random_seed(config["random_seed"], config["deterministic"])
    apply_matmul_precision(config)
    if mesh is None:
        mesh = resolve_mesh_from_config(config)
    model = build_model(config)

    ds_cls = TactileSRDatasetSeq if seqs else TactileSRDataset
    lr_train, hr_train = ds_cls(config["train_dataset_dir"]).stacked()
    lr_test, hr_test = ds_cls(config["test_dataset_dir"]).stacked()
    logger.info("train dataset size: %d", lr_train.shape[0])
    logger.info("test dataset size: %d", lr_test.shape[0])

    trainer = build_trainer(config, model, {"LR": lr_train, "HR": hr_train}, seqs=seqs, mesh=mesh,
                            max_epochs=max_epochs)
    cnn = config.get("model_arch", "TactileSR") == "TactileSRCNN"
    test_arrays = {"LR": lr_test, "HR": hr_test}
    trainer.register_hooks([EvalHook(1, build_eval_fn(trainer, test_arrays))])
    if config.get("dead_head_check", True) and dist.is_main_process():
        probe = lr_test[:, : config["seqsCnt"] * config["axisCnt"]]
        trainer.register_hooks([DeadHeadHook(probe, action=config.get("dead_head_action", "warn"),
                                             head_module=CNN_HEAD_MODULE if cnn else HEAD_MODULE,
                                             reinit_seed=config["random_seed"])])
    if config.get("inference_test") and dist.is_main_process():  # PNGs write once
        trainer.register_hooks([InferenceHookSR(test_arrays, config)])
    trainer.register_hooks(list(hooks))

    trainer.train(auto_resume=auto_resume)
    return trainer


def _cli(argv=None, seqs: bool = False, hooks: Sequence[HookBase] = ()) -> SRTrainer:
    from ..config.parser import ConfigArgumentParser, add_config_args, apply_overrides

    base = tactileSeqs_config if seqs else tactileSR_config
    prog = "sr_seqs_task" if seqs else "sr_task"
    parser = ConfigArgumentParser(prog=f"python -m tactilesr_torch.tasks.{prog}",
                                  description="MTSR training (stage 3, seqs)" if seqs
                                  else "STSR training (stage 3)")
    add_config_args(parser, base)
    config = apply_overrides(base, parser.parse_args(argv))
    return main(config, seqs=seqs, hooks=hooks)


if __name__ == "__main__":
    _cli()
