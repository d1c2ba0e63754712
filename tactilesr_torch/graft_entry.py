"""The root ``__graft_entry__.py``'s two entry points, for the port.

``entry(device="cuda")`` returns the flagship network's eval forward and its
example input: a seeded full-width bf16 STSR (``flagship_model``:
scale 10, 6 MSRB, 1 ResBlock, weights from
``torch.Generator().manual_seed(0)``) as an ``nn.Module`` in
eval mode, and a (32, 3, 4, 4) f32 batch drawn from
``np.random.default_rng(0)`` (the JAX entry's), both on ``device``.
``model(x)`` is a (32, 1, 40, 40) f32 map.

``dryrun_multichip(n, device="cuda")`` runs the training recipe
data-parallel at toy size: it starts ``n`` ranks (processes joined through
the ``TACTILESR_*`` variables), each of which runs the same sequence over
an ``n``-rank mesh -- the STSR recipe with ``scan_epochs`` for 2 epochs
with sharded eval, a resume from ``latest.pth`` to epoch 4, ``SRPredictor``
over an ``n``-device mesh against the trained model's eval forward, one
epoch of the tPSF recipe and one of ``grad_accum=2`` -- and prints JAX's
summary line.  On CUDA the ranks join under NCCL (one card each), and a
replay of the captured step must launch an NCCL kernel; on the CPU they
join under gloo.

    python -m tactilesr_torch.graft_entry [--ranks N] [--device cpu]
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .parallel.dist import rank_results, spawn_local_ranks
from .runtime.device import device_ops, resolve_device

__all__ = ["entry", "dryrun_multichip"]

RANK_TIMEOUT_S = 900


def flagship_model(dtype=torch.float32):
    """A seeded STSR at ``tactileSR_config``'s widths
    (``torch.Generator().manual_seed(0)``), computing in ``dtype``."""
    from .models.tactile_sr import TactileSR

    return TactileSR(scale_factor=10, seqs_cnt=1, axis_cnt=3, pattern_feature_extra_layer_cnt=6,
                     force_feature_extra_layer_cnt=1, dtype=dtype,
                     generator=torch.Generator().manual_seed(0))


def entry(device="cuda"):
    dev = resolve_device(device)
    model = flagship_model(dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).random((32, 3, 4, 4)).astype(np.float32))
    return model.to(dev).eval(), x.to(dev)


def _write_data(work: str, n_ranks: int) -> dict:
    """The JAX dry run's toy SR pairs (6 steps an epoch) and a raw blob."""
    from .data.synthetic import generate_rotate_dataset

    rng = np.random.default_rng(0)
    batch = max(8, n_ranks)

    def save_npz(name, count):
        lr = (rng.random((count, 3, 4, 4)) * 4).astype(np.float32)
        # HR on the real SRdataset's amplitude (~0-25), so the fresh ReLU head
        # sees sanely scaled targets and visibly learns in 2 epochs
        hr = 6.0 * np.repeat(np.repeat(lr[:, 2:3], 25, 2), 25, 3)
        path = os.path.join(work, name)
        np.savez(path, LR=lr, HR=hr.astype(np.float32))
        return path

    raw = os.path.join(work, "rotateDataset")
    generate_rotate_dataset(raw, names=("C",), taps_per_blob=9, seqs=8)
    return {"train": save_npz("train.npz", batch * 6), "test": save_npz("test.npz", 2 * n_ranks),
            "raw": raw, "batch": batch}


def _rank(work: str, device: str) -> dict:
    """One rank's dry run (the body of ``__graft_entry__.dryrun_multichip``)."""
    from .config.default import tactileSR_config, tPSFNet_config
    from .parallel import (all_gather_object, get_rank, get_world_size, init_distributed,
                           local_devices, make_mesh)
    from .serving import SRPredictor
    from .tasks.sr_task import main as sr_main
    from .tasks.tpsf_task import main as tpsf_main

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_distributed(device=device)
    n = get_world_size()
    mesh = make_mesh()
    with open(os.path.join(work, "data.json")) as f:
        data = json.load(f)

    cfg = dict(tactileSR_config)
    cfg.update(
        train_dataset_dir=data["train"],
        test_dataset_dir=data["test"],
        save_dir=os.path.join(work, "run"),
        train_batch_size=data["batch"],
        test_batch_size=n,  # divisible: sharded eval
        patternFeatureExtraLayerCnt=1,
        forceFeatureExtraLayerCnt=1,
        scale_factor=4,
        # the recipe shields its fresh ReLU head behind a 2000-step warmup;
        # every dry-run step stays inside warmup for the same reason
        warmup_t=100,
        lr=3e-4,
        compute_dtype="float32",
        # f32 convolutions without TF32 on a GPU: the served checkpoint is held
        # against the eval forward at 1e-4 of its range
        matmul_precision="highest",
        inference_test=False,
        scan_epochs=True,
        device=device,
    )
    trainer = sr_main(cfg, mesh=mesh, max_epochs=2)
    nccl_ops = None
    if trainer._graph is not None and n > 1:  # a captured epoch under NCCL
        nccl_ops = _replay_nccl_ops(trainer)
        assert nccl_ops, "a replay of the captured step launched no NCCL kernel"
    loss_a = trainer.metric_storage["total_loss"].latest if get_rank() == 0 else None
    psnr_a = trainer.metric_storage["test_PSNR"].latest
    assert np.isfinite(psnr_a)
    if get_rank() == 0:
        assert np.isfinite(loss_a)
        ckpts = sorted(os.listdir(trainer.ckpt_dir))
        assert "epoch_1.pth" in ckpts and "latest.pth" in ckpts, ckpts

    trainer2 = sr_main(cfg, mesh=mesh, max_epochs=4, auto_resume=True)
    assert trainer2.start_iter == 2 * trainer2.epoch_len, (trainer2.start_iter, trainer2.epoch_len)
    digests = all_gather_object(trainer2.state_digest())
    assert len(set(digests)) == 1, f"the replicas differ after the resume: {digests}"
    out = {"rank": get_rank(), "world": n, "psnr_a": psnr_a, "nccl_ops": nccl_ops}
    if get_rank() == 0:
        loss_b = trainer2.metric_storage["total_loss"].latest
        assert np.isfinite(loss_b) and loss_b < loss_a, (loss_b, loss_a)
        out["ckpts"] = sorted(os.listdir(trainer2.ckpt_dir))
        assert "epoch_3.pth" in out["ckpts"], out["ckpts"]
        with np.load(data["test"]) as z:
            lr_eval = z["LR"]
        local = local_devices(device)  # one replica a local device, or n on the one
        pred = SRPredictor(os.path.join(trainer2.ckpt_dir, "latest.pth"),
                           scale_factor=cfg["scale_factor"], pattern_layers=1, force_layers=1,
                           compute_dtype="float32", buckets=(lr_eval.shape[0],),
                           mesh=make_mesh([local[i % len(local)] for i in range(n)]))
        sr = pred.predict(lr_eval)
        want = trainer2.model_apply(torch.from_numpy(lr_eval).to(trainer2.device)).cpu().numpy()
        serve_dev = float(np.abs(sr - want).max())
        assert serve_dev < 1e-4 * max(float(np.abs(want).max()), 1.0), serve_dev
        out.update(loss_a=loss_a, loss_b=loss_b, serve_dev=serve_dev)

    tcfg = dict(tPSFNet_config)
    tcfg.update(dataset_dir=data["raw"], save_dir=os.path.join(work, "tpsf_run"), sample_cnt=1,
                train_batch_size=2 * n, test_batch_size=n, compute_dtype="float32",
                inference_test=False, device=device)
    tpsf = tpsf_main(tcfg, mesh=mesh, max_epochs=1)

    gcfg = dict(cfg, save_dir=os.path.join(work, "run_accum"), train_batch_size=2 * n,
                grad_accum=2, scan_epochs=False)
    accum = sr_main(gcfg, mesh=mesh, max_epochs=1)
    if get_rank() == 0:
        out["tpsf_loss"] = tpsf.metric_storage["total_loss"].latest
        out["accum_loss"] = accum.metric_storage["total_loss"].latest
        assert np.isfinite(out["tpsf_loss"]) and np.isfinite(out["accum_loss"]), out
    return out


def _replay_nccl_ops(trainer) -> list:
    """The NCCL kernels among the device ops of one replay of ``trainer``'s
    captured step (torch.profiler; every rank replays, as the collectives
    ask).  The replay reads row 0 of the epoch and moves the model, which
    the run's checkpoints no longer need."""
    from torch.profiler import ProfilerActivity, profile

    trainer._scan.k.zero_()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._graph.replay()
        torch.cuda.synchronize()
    return sorted({e.key for e in device_ops(prof) if "nccl" in e.key.lower()})


def dryrun_multichip(n_devices: int = 2, device="cuda") -> str:
    """The dry run over ``n_devices`` ranks (see the module docstring);
    raises if any rank fails, else prints and returns the summary line."""
    dev = resolve_device(device)
    work = tempfile.mkdtemp(prefix="graft_dryrun_")
    try:
        with open(os.path.join(work, "data.json"), "w") as f:
            json.dump(_write_data(work, n_devices), f)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        procs = spawn_local_ranks(
            [sys.executable, "-m", "tactilesr_torch.graft_entry", "--rank-of", work, "--device",
             str(dev)], n_devices,
            env={"PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])})
        results = rank_results(procs, RANK_TIMEOUT_S)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0 = results[0]
    nccl = "" if r0["nccl_ops"] is None else f", each replay launching {', '.join(r0['nccl_ops'])}"
    line = (
        f"dryrun_multichip OK: {n_devices}-device mesh {{'data': {n_devices}}} | "
        f"epoch-scan DP training 2 epochs (loss {r0['loss_a']:.5f}, sharded eval PSNR "
        f"{r0['psnr_a']:.2f} dB{nccl}) | resumed from epoch_1 and trained to epoch 3 (loss "
        f"{r0['loss_b']:.5f}) | checkpoints {r0['ckpts']} | fused SRPredictor served the "
        f"checkpoint over the mesh (predict-vs-eval max dev {r0['serve_dev']:.2e}) | tPSF recipe "
        f"under the mesh: 1 epoch, loss {r0['tpsf_loss']:.5f} | grad_accum=2 sharded "
        f"micro-batches: 1 epoch, loss {r0['accum_loss']:.5f}"
    )
    print(line, flush=True)
    return line


def _cli(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m tactilesr_torch.graft_entry",
                                description="data-parallel dry run of the training recipes")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank-of", metavar="WORK", default=None,
                   help="run one rank of a dry run whose data is in WORK (started by the dry run)")
    args = p.parse_args(argv)
    if args.rank_of:
        print("RESULT " + json.dumps(_rank(args.rank_of, args.device)), flush=True)
    else:
        dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    _cli()
