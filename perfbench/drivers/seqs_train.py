"""Captured MTSR training: the seqs recipe's own trainer
(``tactilesr_torch.tasks.sr_task.build_trainer(..., seqs=True)``, as
``sr_seqs_task`` builds it, ``scan_epochs`` on and Adam capturable) on
seeded rows, epochs back to back through ``train_one_epoch_scan`` (on a
card each step after the warm-up one replay of the captured step).

Traffic keys: those of ``drivers/train.py``.  Set-up seeds an STSR at the
configuration's widths with one reading (``seqsCnt`` 1, from another seed)
and writes it as a checkpoint bundle, seeds the MTSR, and builds the one
trainer the window drives with ``load_checkpoint_dir`` at that bundle: the
trunk is transferred from the STSR and the recipe's own warm-up rule holds.
Its first epoch's first ``checked_steps`` steps are followed by the f32
reference from the transferred state (built here by the upstream rule:
every ``patternFeatureExtra_layer`` and ``forceFeatureExtra_layer`` tensor
from the STSR, every other tensor the MTSR's), on the same rows and at the
rates the configuration states (StepLR's, as its ``seqs_use_warmup`` is
false).  On a card steps
1-3 are eager, 4 captures, 5 replays, so replays are compared.  The window
and ``train_samples_per_s`` are as in ``drivers/train.py``.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench.common import free_program, peak_memory, write_checkpoint
from perfbench.core import Outcome
from perfbench.devtrace import Spans, traced
from perfbench.drivers.train import (RECIPE_KEYS, epoch, reference_numbers as recipe_numbers, seeded_rows,
                                     watch_first_steps)
from perfbench.inputs import norm_seed
from perfbench.reference.compare import training_numbers
from perfbench.weights import seeded_state_dict
from perfbench.workcount import TRAIN_FORWARDS, config_flops_per_frame

TRUNK = ("patternFeatureExtra_layer.", "forceFeatureExtra_layer.")  # upstream tactileSRSeqs_train.py's transfer
STSR_SEED = 0x5757  # the STSR's seed: the run's, xor this


def seeded_start(cfg: dict, seed: int, device):
    """(the seeded MTSR, the seeded STSR, the MTSR after the trunk transfer)."""
    mtsr = seeded_state_dict(cfg, seed, device)
    stsr = seeded_state_dict(dict(cfg, seqsCnt=1), norm_seed(seed) ^ STSR_SEED, device)
    return mtsr, stsr, {k: stsr[k] if k.startswith(TRUNK) else v for k, v in mtsr.items()}


def reference_numbers(cfg: dict, tr: dict, start: dict, lr_rows, hr_rows, seed: int, **kw) -> dict:
    """``drivers/train.py``'s reference numbers from ``start`` at the seqs
    recipe's rates: unless the configuration's ``seqs_use_warmup``, without
    its warm-up, so ``recipe_lrs`` gives StepLR's."""
    warmup_t = cfg["warmup_t"] if cfg.get("seqs_use_warmup", False) else 0
    return recipe_numbers(dict(cfg, warmup_t=warmup_t), tr, start, lr_rows, hr_rows, seed, **kw)


def build_trainer(cfg: dict, tr: dict, mtsr: dict, bundle: str, lr_rows, hr_rows, cell):
    """The seqs recipe's trainer on the card, the seeded MTSR loaded and its
    trunk transferred from ``bundle``; no eval, dead-head or inference hook
    runs, and no checkpoint is written in the window."""
    import sys

    from tactilesr_torch.config import tactileSeqs_config
    from tactilesr_torch.runtime.logger import setup_logger
    from tactilesr_torch.runtime.misc import apply_matmul_precision
    from tactilesr_torch.tasks.sr_task import build_model, build_trainer as recipe_trainer

    recipe = dict(tactileSeqs_config, **{k: cfg[k] for k in RECIPE_KEYS}, train_batch_size=tr["batch"],
                  scan_epochs=True, device=str(cell.device), random_seed=norm_seed(cell.seed),
                  save_dir=cell.scratch, load_checkpoint_dir=bundle)
    apply_matmul_precision(recipe)
    setup_logger("tactilesr_torch", stream=sys.stderr)  # before the trainer's: stdout ends with the result line
    model = build_model(recipe)
    model.load_state_dict({k: v.cpu() for k, v in mtsr.items()})
    trainer = recipe_trainer(recipe, model, {"LR": lr_rows.cpu().numpy(), "HR": hr_rows.cpu().numpy()},
                             seqs=True, max_epochs=10**6)
    if cell.device.type == "cuda":
        trainer.optimizer.make_capturable()
    trainer.model.train()
    return trainer


def run(cell) -> Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    mtsr, stsr, start = seeded_start(cfg, cell.seed, dev)
    lr_rows, hr_rows = seeded_rows(cfg, tr, cell.seed, dev)
    trainer = build_trainer(cfg, tr, mtsr, write_checkpoint(stsr, cell.scratch), lr_rows, hr_rows, cell)
    snap = watch_first_steps(trainer, tr["checked_steps"])
    epoch(trainer)  # warm-up and capture, and the checked steps
    setup_losses = trainer._scan.losses["total_loss"].tolist()
    losses = setup_losses[: tr["checked_steps"]]
    prog = {"losses": losses, "grad": snap.get("grad", {}),
            "change": {k: p - start[k] for k, p in snap.get("params", {}).items()},
            "stats": {k: b - start[k] for k, b in snap.get("stats", {}).items()}}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    steps = trainer.epoch_len

    epochs = 0
    t_start = time.perf_counter()
    while True:
        epoch(trainer)
        epochs += 1
        t_end = time.perf_counter()
        if t_end - t_start >= cell.seconds:
            break
    sps = epochs * steps * tr["batch"] / (t_end - t_start)
    last = trainer._scan.losses["total_loss"].tolist()
    bad = sum(not (math.isfinite(v) and v > 0) or v == u for v, u in zip(last, setup_losses))

    trace = None
    if cell.trace:
        spans = Spans()
        with traced(spans, dev.type == "cuda") as trace:
            for _ in range(tr["traced_epochs"]):
                with spans.span("epoch", steps=steps):
                    epoch(trainer)
        trace.counters = dict(steps=tr["traced_epochs"] * steps, samples=tr["traced_epochs"] * steps * tr["batch"],
                              samples_per_s=sps,
                              flops_per_sample=TRAIN_FORWARDS * config_flops_per_frame(cfg))
    memory = peak_memory(dev)
    del trainer
    free_program(dev)

    ref = reference_numbers(cfg, tr, start, lr_rows, hr_rows, cell.seed)
    checks = dict(training_numbers(prog, ref), window_bad_losses=bad)
    return Outcome(e2e={"train_samples_per_s": sps}, attempted=epochs * steps, failed=0, checks=checks,
                   window_start=t_start, trace=trace, memory_peak=memory, details={"window_s": t_end - t_start},
                   notes=[f"{epochs} epochs of {steps} steps in {t_end - t_start:.3f} s; checked steps "
                          f"{tr['checked_steps']} ({snap['replays']} of them replays): losses {losses} "
                          f"against {ref['losses']}; the window's last epoch: {bad} bad losses"])


def control(cell) -> dict:
    """The numbers of the control (fp8 convolutions) and of a planted
    fault (half of each batch left out, the mean over the rest), each in
    the program's place against the f32 reference, from the same
    transferred state on the same rows."""
    from perfbench.reference.lowp import fp8_conv2d

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    _, _, start = seeded_start(cfg, cell.seed, dev)
    lr_rows, hr_rows = seeded_rows(cfg, tr, cell.seed, dev)
    ref = reference_numbers(cfg, tr, start, lr_rows, hr_rows, cell.seed)
    return {name: training_numbers(reference_numbers(cfg, tr, start, lr_rows, hr_rows, cell.seed, **kw), ref)
            for name, kw in (("fp8", dict(conv=fp8_conv2d)), ("half_batch", dict(keep=tr["batch"] // 2)))}
