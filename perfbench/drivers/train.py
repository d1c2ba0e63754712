"""Captured training: ``tactilesr_torch``'s ``SRTrainer(scan_epochs=True)``
on seeded rows, epochs back to back through ``train_one_epoch_scan`` (on a
card each step after the warm-up one replay of the captured step).

Traffic keys: ``batch``, ``steps_per_epoch``, ``reading_range`` (LR),
``label_range`` (HR, 100x100), ``checked_steps``, ``traced_epochs``.
Set-up builds the one trainer the window drives and runs its first epoch,
whose first ``checked_steps`` steps the f32 reference follows from the
same weights on the same rows and at the recipe's warm-up rates (the
epoch's order and rates worked out again from the seed and the
configuration).  On a card the trainer runs its first steps eagerly and
replays its captured step from then on, as in the window: the checked
steps reach past the eager ones, so that replays are compared.  The window
then runs whole epochs; its last epoch's losses are held finite, positive
and written anew (``window_bad_losses``: the steps that are not).
``train_samples_per_s``: rows of every epoch completed, over the time from
the window's start to the end of the last one (each epoch ends with its
loss fetch).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.common import free_program, peak_memory, tf32_off
from perfbench.core import Outcome
from perfbench.devtrace import Spans, traced
from perfbench.reference.compare import training_numbers
from perfbench.reference.model import build, recipe_lrs, train_steps
from perfbench.inputs import norm_seed
from perfbench.weights import seeded_state_dict
from perfbench.workcount import TRAIN_FORWARDS, config_flops_per_frame

ADAM_B1 = 0.9  # the recipe's (adam_l2's default)
RECIPE_KEYS = ("scale_factor", "seqsCnt", "axisCnt", "patternFeatureExtraLayerCnt", "forceFeatureExtraLayerCnt",
               "HR_scale_num", "compute_dtype", "matmul_precision", "lr", "weight_decay",
               "lr_scheduler_step_size", "lr_scheduler_gamma", "warmup_t", "warmup_mode", "warmup_init_lr",
               "warmup_factor")


def seeded_rows(cfg: dict, tr: dict, seed: int, device):
    """(LR (n, C, 4, 4), HR (n, 1, 100, 100)) f32 on ``device``."""
    n = tr["batch"] * tr["steps_per_epoch"]
    gen = torch.Generator(device=device).manual_seed(norm_seed(seed) ^ 0x5EED)
    (a, b), (c, d) = tr["reading_range"], tr["label_range"]
    lr = a + (b - a) * torch.rand((n, cfg["seqsCnt"] * cfg["axisCnt"], 4, 4), generator=gen, device=device)
    hr = c + (d - c) * torch.rand((n, 1, 100, 100), generator=gen, device=device)
    return lr, hr


def first_batches(seed: int, n: int, batch: int, steps: int) -> list:
    """The rows of an epoch's first ``steps`` batches: a permutation by a
    generator seeded with the run's seed (the trainer's first draw)."""
    order = np.random.default_rng(norm_seed(seed)).permutation(n)
    return [order[k * batch:(k + 1) * batch] for k in range(steps)]


def build_trainer(cfg: dict, tr: dict, state: dict, lr_rows, hr_rows, cell):
    import sys

    from tactilesr_torch.config import tactileSR_config
    from tactilesr_torch.runtime.logger import setup_logger
    from tactilesr_torch.runtime.misc import apply_matmul_precision
    from tactilesr_torch.runtime.optim import adam_l2
    from tactilesr_torch.runtime.schedule import LRWarmupSchedule, StepLR
    from tactilesr_torch.tasks.sr_task import SRTrainer, build_model

    recipe = dict(tactileSR_config, **{k: cfg[k] for k in RECIPE_KEYS}, train_batch_size=tr["batch"],
                  device=str(cell.device), random_seed=norm_seed(cell.seed))
    apply_matmul_precision(recipe)
    setup_logger("tactilesr_torch", stream=sys.stderr)  # before the trainer's: stdout ends with the result line
    model = build_model(recipe)
    model.load_state_dict({k: v.cpu() for k, v in state.items()})
    trainer = SRTrainer(
        config=recipe, model=model,
        optimizer=adam_l2(model.parameters(), weight_decay=recipe["weight_decay"]),
        lr_schedule=LRWarmupSchedule(StepLR(recipe["lr"], recipe["lr_scheduler_step_size"],
                                            recipe["lr_scheduler_gamma"]),
                                     by_epoch=True, epoch_len=tr["steps_per_epoch"], warmup_t=recipe["warmup_t"],
                                     warmup_mode=recipe["warmup_mode"], warmup_init_lr=recipe["warmup_init_lr"],
                                     warmup_factor=recipe["warmup_factor"]),
        train_arrays={"LR": lr_rows.cpu().numpy(), "HR": hr_rows.cpu().numpy()},
        batch_size=tr["batch"], max_epochs=10**6, work_dir=cell.scratch, scan_epochs=True,
        device=cell.device, seed=norm_seed(cell.seed))
    if cell.device.type == "cuda":
        trainer.optimizer.make_capturable()
    trainer.model.train()
    return trainer


def watch_first_steps(trainer, steps: int) -> dict:
    """Snapshot the program's state after its first and ``steps``-th step:
    each outermost ``_scan_one`` call is one step (eager, or a replay;
    ``snap["replays"]`` counts the replays among them)."""
    snap, depth, count = {"replays": 0}, [0], [0]
    inner = trainer._scan_one
    named = dict(trainer.model.named_parameters())
    state = trainer.optimizer.optimizer.state

    def one():
        depth[0] += 1
        try:
            inner()
        finally:
            depth[0] -= 1
        if depth[0]:
            return
        count[0] += 1
        snap["replays"] += getattr(trainer, "_graph", None) is not None
        with torch.no_grad():
            if count[0] == 1:
                snap["grad"] = {k: state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1 - ADAM_B1)
                                for k, p in named.items()}
            if count[0] == steps:
                snap["params"] = {k: p.detach().clone() for k, p in named.items()}
                snap["stats"] = {k: b.clone() for k, b in trainer.model.named_buffers()
                                 if k.endswith(("running_mean", "running_var"))}
        if count[0] == steps:
            trainer._scan_one = inner

    trainer._scan_one = one
    return snap


def reference_numbers(cfg: dict, tr: dict, state: dict, lr_rows, hr_rows, seed: int, conv=None, keep=0) -> dict:
    """The reference's first steps from ``state``: losses, first gradient
    (with and without its decay term), parameter and statistics changes."""
    model = build(cfg, lr_rows.device)
    model.load_state_dict(state)
    batches = [torch.from_numpy(b).to(lr_rows.device)
               for b in first_batches(seed, lr_rows.shape[0], tr["batch"], tr["checked_steps"])]
    lrs = recipe_lrs(cfg, tr["steps_per_epoch"], len(batches))
    with tf32_off():
        losses, first = train_steps(model, lr_rows, hr_rows, batches, cfg, lrs, conv, keep)
    wd = cfg["weight_decay"]
    params = dict(model.named_parameters())
    return {"losses": losses, "grad": first,
            "raw_grad": {k: g - wd * state[k] for k, g in first.items()},
            "change": {k: p.detach() - state[k] for k, p in params.items()},
            "stats": {k: b - state[k] for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))}}


def epoch(trainer) -> None:
    """One epoch through the window's call, the iteration count advanced as
    the trainer's own epoch loop advances it."""
    trainer.train_one_epoch_scan()
    trainer.cur_iter += trainer.epoch_len


def run(cell) -> Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    state = seeded_state_dict(cfg, cell.seed, dev)
    lr_rows, hr_rows = seeded_rows(cfg, tr, cell.seed, dev)
    trainer = build_trainer(cfg, tr, state, lr_rows, hr_rows, cell)
    snap = watch_first_steps(trainer, tr["checked_steps"])
    epoch(trainer)  # warm-up and capture, and the checked steps
    setup_losses = trainer._scan.losses["total_loss"].tolist()
    losses = setup_losses[: tr["checked_steps"]]
    prog = {"losses": losses, "grad": snap.get("grad", {}),
            "change": {k: p - state[k] for k, p in snap.get("params", {}).items()},
            "stats": {k: b - state[k] for k, b in snap.get("stats", {}).items()}}
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

    ref = reference_numbers(cfg, tr, state, lr_rows, hr_rows, cell.seed)
    checks = dict(training_numbers(prog, ref), window_bad_losses=bad)
    return Outcome(e2e={"train_samples_per_s": sps}, attempted=epochs * steps, failed=0, checks=checks,
                   window_start=t_start, trace=trace, memory_peak=memory, details={"window_s": t_end - t_start},
                   notes=[f"{epochs} epochs of {steps} steps in {t_end - t_start:.3f} s; checked steps "
                          f"{tr['checked_steps']} ({snap['replays']} of them replays): losses {losses} "
                          f"against {ref['losses']}; the window's last epoch: {bad} bad losses"])


def control(cell) -> dict:
    """The numbers of the control (fp8 convolutions) and of a planted
    fault (half of each batch left out, the mean over the rest), each in
    the program's place against the f32 reference, from the same state on
    the same rows."""
    from perfbench.reference.lowp import fp8_conv2d

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    state = seeded_state_dict(cfg, cell.seed, dev)
    lr_rows, hr_rows = seeded_rows(cfg, tr, cell.seed, dev)
    ref = reference_numbers(cfg, tr, state, lr_rows, hr_rows, cell.seed)
    out = {}
    for name, kw in (("fp8", dict(conv=fp8_conv2d)), ("half_batch", dict(keep=tr["batch"] // 2))):
        out[name] = training_numbers(reference_numbers(cfg, tr, state, lr_rows, hr_rows, cell.seed, **kw), ref)
    return out
