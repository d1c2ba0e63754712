"""Captured tPSFNet stage-1 training: ``tactilesr_torch``'s recipe
(``tasks/tpsf_task.py``: ``build_model``, then ``build_trainer`` with
``scan_epochs`` on) on seeded rows, epochs back to back through
``train_one_epoch_scan`` (on a card each step after the warm-up one replay
of the captured step: the MLP in the configuration's ``compute_dtype``, the
physics through its CUDA kernels).

Traffic keys: ``batch`` (the recipe's ``train_batch_size``),
``steps_per_epoch``, ``reading_range`` (raw readings, divided by
``scale_num`` in the step), ``distinct_depths`` (0/1 contact maps, each
the depth of ``batch * steps_per_epoch / distinct_depths`` rows, as a tap's
samples share its map), ``checked_steps``, ``traced_epochs``.

Set-up builds the one trainer the window drives and runs its first epoch.
The f32 reference (``reference/tpsf.py``, the direct form) follows its
first ``checked_steps`` steps from the same weights on the same rows at the
recipe's rates, after the window: on a card steps 1-3 are eager, 4
captures, 5 replays, so replays are compared.  The physics is also held
alone, on the captured step (on a card its tensors as the replay after the
capture leaves them): the program's own (alpha, beta, m) from that step's
forward go to the reference's physics, so the MLP's rounding stays out
(``hr_gap``, ``lr_gap``: the relative RMS of the step's HR and LR against
the reference's; ``abm_grad_gap``: the gradient of (alpha, beta, m) that
the step's backward took, against the reference's autograd under the
step's own LR cotangent, the worst of the three).  The window runs whole
epochs; its last epoch's losses are held finite, positive and written anew
(``window_bad_losses``); they run at the first epoch's learning rate, as
``epoch`` runs no per-epoch hook (StepLR does not step), as in
``drivers/train.py``.  ``train_samples_per_s``: rows of every epoch
completed, over the time from the window's start to the end of the last
one (each epoch ends with its loss fetch).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.common import free_program, peak_memory
from perfbench.core import Outcome
from perfbench.devtrace import Spans, traced
from perfbench.drivers.train import epoch, first_batches, watch_first_steps
from perfbench.inputs import norm_seed
from perfbench.physics_count import step_least_seconds_per_sample
from perfbench.reference import tpsf as ref
from perfbench.reference.compare import training_numbers

WEIGHT_STD = 0.03  # upstream tPSFNet.py:64-65: Linear weights N(0, 0.03), biases 0
RECIPE_KEYS = ("lr", "weight_decay", "lr_scheduler_step_size", "lr_scheduler_gamma", "scale_num",
               "physics_precision", "compute_dtype")


def seeded_state_dict(seed: int, device) -> dict:
    """The MLP's upstream init from the seed, drawn on ``device``: one
    normal buffer sliced by weight, the biases 0."""
    shapes = {k: v.shape for k, v in ref.build("meta").state_dict().items()}
    weights = [k for k in shapes if k.endswith("weight")]
    gen = torch.Generator(device=device).manual_seed(norm_seed(seed))
    flat = WEIGHT_STD * torch.randn(sum(math.prod(shapes[k]) for k in weights), generator=gen, device=device)
    out, i = {}, 0
    for k, shape in shapes.items():
        if k in weights:
            n = math.prod(shape)
            out[k] = flat[i:i + n].view(shape).clone()
            i += n
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def contact_maps(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 100, 100) 0/1 contact maps, as ``binarize_depth`` leaves a
    pressed object's: per map a disc, square, ring or two letter strokes
    (a bar and a cross-bar), centred in [25, 75), 8-30 pixels in half size."""
    u = torch.rand((n, 6), generator=gen, device=device)
    kind = (4 * u[:, 0]).long().view(-1, 1, 1)
    cx, cy = (25 + 50 * u[:, 1]).view(-1, 1, 1), (25 + 50 * u[:, 2]).view(-1, 1, 1)
    size = (8 + 22 * u[:, 3]).view(-1, 1, 1)
    width = (2 + 4 * u[:, 4]).view(-1, 1, 1)  # a stroke's half width
    cross = ((2 * u[:, 5] - 1)).view(-1, 1, 1) * size  # the cross-bar's offset along the bar
    y, x = torch.meshgrid(torch.arange(100.0, device=device), torch.arange(100.0, device=device), indexing="ij")
    dx, dy = x[None] - cx, y[None] - cy
    r2 = dx ** 2 + dy ** 2
    shapes = torch.stack([s.float() for s in (
        r2 <= size ** 2,
        (dx.abs() <= size) & (dy.abs() <= size),
        (r2 <= size ** 2) & (r2 >= (0.6 * size) ** 2),
        ((dx.abs() <= width) & (dy.abs() <= size)) | (((dy - cross).abs() <= width) & (dx.abs() <= 0.8 * size)),
    )])
    return torch.gather(shapes, 0, kind[None].expand(1, n, 100, 100))[0]


def seeded_rows(tr: dict, seed: int, device):
    """(readings (n, 3, 4, 4), the distinct maps (k, 100, 100), rows per
    map): row r's map is ``maps[r // per]``."""
    n, k = tr["batch"] * tr["steps_per_epoch"], tr["distinct_depths"]
    if n % k:
        raise ValueError(f"{n} rows do not split into {k} maps")
    gen = torch.Generator(device=device).manual_seed(norm_seed(seed) ^ 0x7F5F)
    a, b = tr["reading_range"]
    readings = a + (b - a) * torch.rand((n, 3, 4, 4), generator=gen, device=device)
    return readings, contact_maps(k, gen, device), n // k


def build_trainer(cfg: dict, tr: dict, state: dict, readings, maps, per: int, cell):
    """The recipe's trainer as ``tpsf_task.main`` builds it, on the card,
    with the seeded weights; no eval, inference-curve or checkpoint hook runs."""
    import sys

    from tactilesr_torch.config import tPSFNet_config
    from tactilesr_torch.runtime.logger import setup_logger
    from tactilesr_torch.runtime.misc import apply_matmul_precision
    from tactilesr_torch.tasks.tpsf_task import build_model, build_trainer as recipe_trainer

    recipe = dict(tPSFNet_config, **{k: cfg[k] for k in RECIPE_KEYS}, train_batch_size=tr["batch"],
                  scan_epochs=True, device=str(cell.device), random_seed=norm_seed(cell.seed),
                  save_dir=cell.scratch)
    apply_matmul_precision(recipe)
    setup_logger("tactilesr_torch", stream=sys.stderr)  # before the trainer's: stdout ends with the result line
    model = build_model(recipe)
    model.load_state_dict({k: v.cpu() for k, v in state.items()})
    depth = np.repeat(maps.cpu().numpy(), per, axis=0)
    trainer = recipe_trainer(recipe, model, {"LR": readings.cpu().numpy(), "depth": depth})
    if cell.device.type == "cuda":
        trainer.optimizer.make_capturable()
    trainer.model.train()
    return trainer


def watch_step_physics(trainer, step: int) -> dict:
    """The physics of the program's ``step``-th step: its depth and (HR, LR,
    abm), and the LR cotangent and abm gradient of its backward, detached.
    Hooks see the ``step``-th forward (on a card, once ``SCAN_WARMUP_STEPS``
    eager steps have run, the capture's); the tensors are copied once that
    step has run (on a card, by its replay)."""
    held, seen, calls, depth, count = {}, {}, [0], [0], [0]

    def hook(_module, args, out):
        calls[0] += 1
        if calls[0] != step:
            return
        handle.remove()
        abm = out[3]._base  # (alpha, beta, m) as the physics took them; out[3] is a view the loss never reads
        held.update(depth=args[1][:, 0], hr=out[0][:, 0], lr=out[1][:, 0], abm=abm)
        out[1].register_hook(lambda g: held.__setitem__("g_lr", g[:, 0]))
        abm.register_hook(lambda g: held.__setitem__("g_abm", g))

    handle = trainer.model.register_forward_hook(hook)
    inner = trainer._scan_one

    def one():
        depth[0] += 1
        try:
            inner()
        finally:
            depth[0] -= 1
        if depth[0]:
            return
        count[0] += 1
        if count[0] == step:
            seen.update({k: v.detach().clone() for k, v in held.items()})
            held.clear()
            trainer._scan_one = inner

    trainer._scan_one = one
    return seen


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    d = float((a.double() - b.double()).square().mean())
    r = float(b.double().square().mean())
    return math.sqrt(d / r) if r > 0 and math.isfinite(d) else math.inf


def physics_numbers(hr, lr, g_abm, want_hr, want_lr, want_g) -> dict:
    """``hr_gap``, ``lr_gap`` and ``abm_grad_gap`` (module docstring)."""
    if g_abm.shape != want_g.shape:
        return {"hr_gap": math.inf, "lr_gap": math.inf, "abm_grad_gap": math.inf}
    cols = [_rel_rms(g_abm[:, c], want_g[:, c]) for c in range(want_g.shape[1])]
    return {"hr_gap": _rel_rms(hr, want_hr), "lr_gap": _rel_rms(lr, want_lr),
            "abm_grad_gap": max(cols) if all(map(math.isfinite, cols)) else math.inf}


def lr_cotangent(lr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The loss's gradient for the step's predicted reading (the MSE against
    the z-channel of the reading / scale_num, over a full batch)."""
    return 2 * (lr.float() - x[:, 2].float()) / lr.numel()


def reference_numbers(cfg: dict, tr: dict, state: dict, readings, maps, per: int, seed: int,
                      physics_fn=ref.physics, keep: int = 0) -> dict:
    """The reference's first steps from ``state``: losses, the first
    gradient (with and without its decay term) and the parameters' change."""
    model = ref.build(readings.device)
    model.load_state_dict(state)
    batches = [torch.from_numpy(b).to(readings.device)
               for b in first_batches(seed, readings.shape[0], tr["batch"], tr["checked_steps"])]
    lrs = [cfg["lr"]] * len(batches)  # the first epoch's: StepLR by epoch, no warm-up
    losses, first = ref.train_steps(model, readings, lambda idx: maps[idx // per], batches, lrs,
                                    cfg["weight_decay"], cfg["scale_num"], physics_fn, keep)
    wd = cfg["weight_decay"]
    return {"losses": losses, "grad": first, "raw_grad": {k: g - wd * state[k] for k, g in first.items()},
            "change": {k: p.detach() - state[k] for k, p in model.named_parameters()}, "stats": {}}


def _training(prog: dict, want: dict) -> dict:
    return {k: v for k, v in training_numbers(prog, want).items() if k != "stats_gap"}  # no BatchNorm here


def run(cell) -> Outcome:
    from tactilesr_torch.runtime.trainer import SCAN_WARMUP_STEPS

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    state = seeded_state_dict(cell.seed, dev)
    readings, maps, per = seeded_rows(tr, cell.seed, dev)
    trainer = build_trainer(cfg, tr, state, readings, maps, per, cell)
    snap = watch_first_steps(trainer, tr["checked_steps"])
    step = watch_step_physics(trainer, SCAN_WARMUP_STEPS + 1)
    epoch(trainer)  # warm-up and capture, and the checked steps
    setup_losses = trainer._scan.losses["total_loss"].tolist()
    prog = {"losses": setup_losses[: tr["checked_steps"]], "grad": snap.get("grad", {}),
            "change": {k: p - state[k] for k, p in snap.get("params", {}).items()}, "stats": {}}
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
                              batch=tr["batch"], samples_per_s=sps,
                              least_s_per_sample=step_least_seconds_per_sample())
    memory = peak_memory(dev)
    del trainer
    free_program(dev)

    want = reference_numbers(cfg, tr, state, readings, maps, per, cell.seed)
    if "g_lr" in step and "g_abm" in step:
        physics = physics_numbers(step["hr"], step["lr"], step["g_abm"],
                                  *ref.physics_grad(step["depth"], step["abm"], step["g_lr"]))
    else:  # the step's forward or backward never ran
        physics = dict.fromkeys(("hr_gap", "lr_gap", "abm_grad_gap"), math.inf)
    checks = dict(_training(prog, want), window_bad_losses=bad, **physics)
    return Outcome(e2e={"train_samples_per_s": sps}, attempted=epochs * steps, failed=0, checks=checks,
                   window_start=t_start, trace=trace, memory_peak=memory, details={"window_s": t_end - t_start},
                   notes=[f"{epochs} epochs of {steps} steps in {t_end - t_start:.3f} s; checked steps "
                          f"{tr['checked_steps']} ({snap['replays']} of them replays): losses {prog['losses']} "
                          f"against {want['losses']}; the window's last epoch: {bad} bad losses"])


def control(cell) -> dict:
    """The numbers of the control (the physics in one bf16 pass) and of a
    planted fault (half of each batch left out, the mean over the rest),
    each in the program's place against the f32 reference, from the same
    state on the same rows; the control's physics at the reference's own
    first-step (alpha, beta, m)."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    state = seeded_state_dict(cell.seed, dev)
    readings, maps, per = seeded_rows(tr, cell.seed, dev)
    want = reference_numbers(cfg, tr, state, readings, maps, per, cell.seed)
    idx = torch.from_numpy(first_batches(cell.seed, readings.shape[0], tr["batch"], 1)[0]).to(dev)
    x, depth = readings[idx] / cfg["scale_num"], maps[idx // per]
    model = ref.build(dev)
    model.load_state_dict(state)
    with torch.no_grad():
        _hr, lr, abm = model(x, depth)
    g_lr = lr_cotangent(lr, x)
    bf16 = physics_numbers(*ref.physics_grad(depth, abm, g_lr, ref.physics_bf16),
                           *ref.physics_grad(depth, abm, g_lr))
    ctl = reference_numbers(cfg, tr, state, readings, maps, per, cell.seed, physics_fn=ref.physics_bf16)
    half = reference_numbers(cfg, tr, state, readings, maps, per, cell.seed, keep=tr["batch"] // 2)
    return {"bf16_physics": dict(_training(ctl, want), **bf16), "half_batch": _training(half, want)}
