"""Data-parallel training in the port, over 2 gloo ranks on the CPU.

One group of 2 worker processes (this file run as a script, ``python
tests/test_torch_dist.py --worker SPEC``; each imports only
``tactilesr_torch``, pins one intra-op thread and joins gloo on a free
loopback port through the ``TACTILESR_*`` variables) runs, in order:

- the cases of ``tests/test_dist_multiprocess.py``'s helper test: world
  size, main process, ``reduce_dict`` averaged and summed,
  ``all_gather_object`` of objects of different sizes, the rooted gather;
- ``BatchNorm`` alone, each rank on its half of one batch, with ``sync``
  set (as the trainer sets it on a mesh) and unset;
- ``sr_task.main`` at toy size in f32 for 3 steps per iteration, each rank
  in a work dir of its own, the final batch padded with its 2 valid rows
  both on rank 0; then ``grad_accum=2`` (batch 16, 3 steps; the last step's
  first micro-batch has 2 valid rows, both on rank 0, its second none);
- the SR eval with a test batch that does not split over the ranks;
- ``scan_epochs`` for one epoch and a resume for a second, in one shared
  work dir;
- one epoch of the tPSF recipe.

While they run, this process computes the references: JAX's ``SRTrainer``
over ``make_mesh()`` on the 8 CPU devices of ``conftest.py`` from the same
weights and data, JAX's ``BatchNorm`` on the whole batch, and the port's
one-process runs.  Each test below reads the group's results.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WORKER_TIMEOUT_S = 300
SR_STEPS = 3
BN_UPDATES = {"iter": (1, 3), "accum": (2, 5)}  # num_batches_tracked after steps 1 and 3
BN_SHAPE = (8, 4, 5, 5)  # NCHW: rank r normalises rows [4r, 4r + 4)


# ------------------------------------------------------------- the worker
def _sr_runs(spec, rank):
    """The SR runs of one rank; their results, and their states saved to
    the spec's directory."""
    from tactilesr_torch.config import tactileSR_config
    from tactilesr_torch.runtime.hooks import HookBase
    from tactilesr_torch.tasks import sr_task

    class _Init(HookBase):  # the JAX initial weights, before the first step
        def before_train(self):
            self.trainer.model.load_state_dict(torch.load(spec["init"]))

    class _Snap(HookBase):
        def __init__(self):
            self.states = []

        def after_iter(self):
            self.states.append({k: v.clone() for k, v in self.trainer.model.state_dict().items()})

    def run(name, overrides, hooks, **kw):
        cfg = {**tactileSR_config, **spec["sr_cfg"], **overrides}
        t = sr_task.main(cfg, hooks=hooks, **kw)
        storage = t.metric_storage
        res = {
            "losses": storage["total_loss"].state_dict()["values"] if "total_loss" in storage
            else [],
            "evals": {k: storage[k].latest for k in ("test_loss", "test_PSNR", "test_SSIM")},
            "start_iter": t.start_iter,
            "ckpts": sorted(os.listdir(t.ckpt_dir)),
            "tb_files": len([p for p in glob.glob(os.path.join(t.tb_log_dir, "**", "*"),
                                                  recursive=True) if os.path.isfile(p)]),
            "rank_log": os.path.exists(os.path.join(t.work_dir, f"log_rank{rank}.txt")),
            "mesh": None if t.mesh is None else t.mesh.size,
        }
        return t, res

    out = {}
    with np.load(spec["test"]) as z:
        test_arrays = {"LR": z["LR"], "HR": z["HR"]}
    for name, overrides in (("iter", {"train_dataset_dir": spec["train"]}),
                            ("accum", {"train_dataset_dir": spec["train_accum"],
                                       "train_batch_size": 16, "grad_accum": 2})):
        snap = _Snap()
        t, res = run(name, dict(overrides, save_dir=os.path.join(spec["out"], f"{name}_{rank}")),
                     [_Init(), snap])
        torch.save({"after_1": snap.states[0], "after_3": snap.states[-1],
                    "optimizer": t.optimizer.state_dict()},
                   os.path.join(spec["out"], f"{name}_state_{rank}.pt"))
        out[name] = res
        if name == "iter":
            out["eval_fallback"] = _eval_fallback(t, test_arrays)
    scan = {"train_dataset_dir": spec["train"], "scan_epochs": True,
            "save_dir": os.path.join(spec["out"], "scan")}
    out["scan"] = run("scan", scan, [_Init()])[1]
    out["resume"] = run("resume", scan, [], max_epochs=2, auto_resume=True)[1]
    return out


def _eval_fallback(t, test_arrays):
    """A test batch of 3 does not split over the 2 ranks: the eval runs
    unsharded on every rank, with JAX's warning, and gives what the eval
    without a mesh gives."""
    import logging

    from tactilesr_torch.tasks import sr_task

    warnings = []

    class _Capture(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    handler = _Capture(logging.WARNING)
    logging.getLogger("tactilesr_torch").addHandler(handler)
    try:
        t.config = {**t.config, "test_batch_size": 3}
        fallback = sr_task.build_eval_fn(t, test_arrays)()
    finally:
        logging.getLogger("tactilesr_torch").removeHandler(handler)
    mesh, t.mesh = t.mesh, None
    plain = sr_task.build_eval_fn(t, test_arrays)()
    t.mesh = mesh
    return {"fallback": fallback, "plain": plain,
            "warned": any("not divisible by the 2-device data axis" in w for w in warnings)}


def _worker(spec_path):
    torch.set_num_threads(1)
    from tactilesr_torch.config import tPSFNet_config
    from tactilesr_torch.models.layers import BatchNorm
    from tactilesr_torch.parallel import (all_gather_object, gather_object, get_rank,
                                          get_world_size, init_distributed, is_main_process,
                                          reduce_dict)
    from tactilesr_torch.tasks import tpsf_task

    with open(spec_path) as f:
        spec = json.load(f)
    rank = init_distributed(device="cpu")  # from the TACTILESR_* variables
    res = {
        "rank": rank,
        "get_rank": get_rank(),
        "world": get_world_size(),
        "main": is_main_process(),
        "reduced_avg": reduce_dict({"loss": float(rank + 1), "acc": 10.0 * (rank + 1)}),
        "reduced_sum": reduce_dict({"loss": float(rank + 1)}, average=False),
        "gathered": all_gather_object(
            {"rank": rank, "tag": "p" * (rank + 1) + str(rank), "nested": [rank, {"x": rank}]}),
        "rooted": gather_object({"r": rank}, dst=0),
    }

    with np.load(spec["bn"]) as z:
        x, cot, scale, bias = (z[k] for k in ("x", "cot", "scale", "bias"))
    rows = slice(rank * BN_SHAPE[0] // WORLD, (rank + 1) * BN_SHAPE[0] // WORLD)
    bn = BatchNorm(BN_SHAPE[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    local = BatchNorm(BN_SHAPE[1]).train()
    local.load_state_dict(bn.state_dict())
    bn.sync = True
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(xr)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    y_local = local(torch.from_numpy(x[rows]))
    np.savez(os.path.join(spec["out"], f"bn_{rank}.npz"), y=y.detach().numpy(),
             gx=xr.grad.numpy(), gw=bn.weight.grad.numpy(), gb=bn.bias.grad.numpy(),
             mean=bn.running_mean.numpy(), var=bn.running_var.numpy(),
             count=bn.num_batches_tracked.numpy(), y_local=y_local.detach().numpy(),
             mean_local=local.running_mean.numpy(), var_local=local.running_var.numpy())

    res.update(_sr_runs(spec, rank))
    tcfg = {**tPSFNet_config, **spec["tpsf_cfg"], "save_dir": os.path.join(spec["out"], "tpsf")}
    t = tpsf_task.main(tcfg, max_epochs=1)
    res["tpsf"] = {"losses": t.metric_storage["total_loss"].state_dict()["values"]
                   if "total_loss" in t.metric_storage else [], "mesh": t.mesh.size}
    print("RESULT " + json.dumps(res), flush=True)


# --------------------------------------------------------------- the parent
def _launch(spec_path):
    from tactilesr_torch.parallel import spawn_local_ranks

    return spawn_local_ranks([sys.executable, os.path.abspath(__file__), "--worker", spec_path],
                             WORLD, env={"PYTHONPATH": ROOT})


def _collect(procs):
    from tactilesr_torch.parallel import rank_results

    return rank_results(procs, WORKER_TIMEOUT_S)


def _jax_sr_run(cfg, lr, hr, batch, grad_accum):
    """JAX's SRTrainer over the 8-device mesh: losses and the state after
    each step, in the port's layout."""
    import jax

    from conftest import make_toy_trainer
    from tactilesr_tpu.parallel.mesh import make_mesh
    from tactilesr_tpu.runtime.hooks import HookBase as JaxHookBase
    from tactilesr_torch.compat.from_jax import tactile_sr_state_dict

    states = []

    class _Snap(JaxHookBase):
        def after_iter(self):
            states.append(tactile_sr_state_dict(jax.device_get(
                {"params": self.trainer.state.params,
                 "batch_stats": self.trainer.state.batch_stats})))

    t = make_toy_trainer(dict(cfg, train_batch_size=batch), lr, hr, max_epochs=1,
                         mesh=make_mesh(), grad_accum=grad_accum)
    t.register_hooks([_Snap()])
    t.train(auto_resume=False)
    return {"losses": t.metric_storage["total_loss"].state_dict()["values"], "states": states}


def _port_sr_run(spec, name, overrides):
    """The same run in one process (no mesh)."""
    from tactilesr_torch.config import tactileSR_config
    from tactilesr_torch.runtime.hooks import HookBase
    from tactilesr_torch.tasks import sr_task

    states = []

    class _Init(HookBase):
        def before_train(self):
            self.trainer.model.load_state_dict(torch.load(spec["init"]))

    class _Snap(HookBase):
        def after_iter(self):
            states.append({k: v.clone() for k, v in self.trainer.model.state_dict().items()})

    cfg = {**tactileSR_config, **spec["sr_cfg"], **overrides,
           "save_dir": os.path.join(spec["out"], f"{name}_one")}
    t = sr_task.main(cfg, hooks=[_Init(), _Snap()])
    assert t.mesh is None
    return {"losses": t.metric_storage["total_loss"].state_dict()["values"], "states": states}


def _jax_bn(x, cot, scale, bias):
    """JAX's BatchNorm over the whole batch: y, input and parameter
    gradients, running statistics (NCHW)."""
    import jax
    import jax.numpy as jnp

    from tactilesr_tpu.models.layers import BatchNorm as JaxBatchNorm

    c = x.shape[1]
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def fwd(xn, params):
        y, mut = JaxBatchNorm().apply({"params": params, "batch_stats": stats}, xn,
                                      use_running_average=False, mutable=["batch_stats"])
        return y, mut

    xn = jnp.asarray(x.transpose(0, 2, 3, 1))
    y, vjp, mut = jax.vjp(fwd, xn, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                          has_aux=True)
    gx, gp = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "gx": nchw(gx), "gw": np.asarray(gp["scale"]),
            "gb": np.asarray(gp["bias"]), "mean": np.asarray(mut["batch_stats"]["mean"]),
            "var": np.asarray(mut["batch_stats"]["var"])}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Launch the worker group, compute every reference meanwhile, collect."""
    import jax

    from conftest import toy_sr_config, toy_sr_data
    from tactilesr_tpu.tasks import sr_task as jax_sr_task
    from tactilesr_torch.compat.from_jax import tactile_sr_state_dict
    from tactilesr_torch.data import generate

    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("dist")
    out = str(tmp / "out")
    os.makedirs(out)
    rng = np.random.default_rng(42)
    lr, hr = toy_sr_data(rng, n=18)  # 3 steps at batch 8: 8, 8 and 2 valid rows
    lr_a, hr_a = toy_sr_data(rng, n=34)  # 3 steps at batch 16: 16, 16 and 2
    lr_t, hr_t = toy_sr_data(rng, n=12)  # test batches of 8: 8 rows and 4
    paths = {}
    for name, a, b in (("train", lr, hr), ("train_accum", lr_a, hr_a), ("test", lr_t, hr_t)):
        paths[name] = str(tmp / f"{name}.npz")
        np.savez(paths[name], LR=a, HR=b)
    jcfg = toy_sr_config(str(tmp / "jax"), test_batch_size=8)
    model = jax_sr_task.build_model(jcfg)
    v = jax.device_get(model.init(jax.random.key(42), np.zeros((1, 3, 4, 4), np.float32),
                                  train=False))
    init = str(tmp / "init.pth")
    torch.save(tactile_sr_state_dict({"params": v["params"], "batch_stats": v["batch_stats"]}),
               init)
    bn_rng = np.random.default_rng(7)
    bn = {"x": bn_rng.standard_normal(BN_SHAPE).astype(np.float32) * 2 + 0.5,
          "cot": bn_rng.standard_normal(BN_SHAPE).astype(np.float32),
          "scale": bn_rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(np.float32),
          "bias": bn_rng.standard_normal(BN_SHAPE[1]).astype(np.float32)}
    np.savez(str(tmp / "bn.npz"), **bn)
    raw = str(tmp / "raw")
    generate._cli(["synthetic", "--out-dir", raw, "--names", "C", "I", "P",
                   "--taps-per-blob", "9", "--seqs", "24"])
    sr_keys = ("train_batch_size", "test_batch_size", "patternFeatureExtraLayerCnt",
               "forceFeatureExtraLayerCnt", "scale_factor", "warmup_t", "compute_dtype",
               "inference_test", "lr", "weight_decay", "random_seed")
    spec = {
        "out": out, "init": init, "bn": str(tmp / "bn.npz"), **paths,
        "sr_cfg": dict({k: jcfg[k] for k in sr_keys}, test_dataset_dir=paths["test"],
                       device="cpu", epochs=1),
        "tpsf_cfg": {"device": "cpu", "dataset_dir": raw, "sample_cnt": 4,
                     "train_batch_size": 16, "compute_dtype": "float32",
                     "inference_test": False},
    }
    spec_path = str(tmp / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    procs = _launch(spec_path)
    try:
        from tactilesr_torch.config import tPSFNet_config
        from tactilesr_torch.tasks import tpsf_task

        refs = {
            "jax_iter": _jax_sr_run(jcfg, lr, hr, 8, 1),
            "jax_accum": _jax_sr_run(jcfg, lr_a, hr_a, 16, 2),
            "jax_bn": _jax_bn(**bn),
            "one_iter": _port_sr_run(spec, "iter", {"train_dataset_dir": paths["train"]}),
            "one_accum": _port_sr_run(spec, "accum", {"train_dataset_dir": paths["train_accum"],
                                                      "train_batch_size": 16, "grad_accum": 2}),
        }
        t = tpsf_task.main({**tPSFNet_config, **spec["tpsf_cfg"], "save_dir": str(tmp / "tpsf1")},
                           max_epochs=1)
        refs["one_tpsf"] = t.metric_storage["total_loss"].state_dict()["values"]
    finally:
        results = _collect(procs)
        torch.set_num_threads(prev_threads)
    return {"results": results, "refs": refs, "spec": spec, "test": (lr_t, hr_t), "jcfg": jcfg}


# ------------------------------------------------------------------ tests
def test_dist_helpers_over_two_ranks(group):
    """tests/test_dist_multiprocess.py's helper cases, bootstrapped through
    the TACTILESR_* variables."""
    results = group["results"]
    assert set(results) == {0, 1}
    for rank, res in results.items():
        assert res["world"] == WORLD and res["get_rank"] == rank
        assert res["main"] == (rank == 0)
        assert res["reduced_avg"] == {"loss": 1.5, "acc": 15.0}
        assert res["reduced_sum"] == {"loss": 3.0}
        assert res["gathered"] == [
            {"rank": 0, "tag": "p0", "nested": [0, {"x": 0}]},
            {"rank": 1, "tag": "pp1", "nested": [1, {"x": 1}]},
        ]
    assert results[0]["rooted"] == [{"r": 0}, {"r": 1}]
    assert results[1]["rooted"] is None


def test_batchnorm_over_two_ranks_matches_jax_on_the_whole_batch(group):
    """Each rank normalises its half of one batch by the global statistics:
    the output and input gradients, concatenated, and the weight and bias
    gradients, summed over the ranks, match JAX's BatchNorm on the whole
    batch at rtol 1e-5; the running statistics (global n's unbiased
    variance) match its batch_stats on both ranks."""
    want = group["refs"]["jax_bn"]
    got = [dict(np.load(os.path.join(group["spec"]["out"], f"bn_{r}.npz"))) for r in range(WORLD)]
    for k in ("y", "gx"):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("gw", "gb"):
        np.testing.assert_allclose(got[0][k] + got[1][k], want[k], rtol=1e-5, err_msg=k)
    for g in got:
        np.testing.assert_allclose(g["mean"], want["mean"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g["var"], want["var"], rtol=1e-5)
        assert int(g["count"]) == 1


def test_batchnorm_without_sync_stays_local_under_a_group(group):
    """Unless the trainer sets ``sync`` (a mesh of more than one rank), the
    layer under a 2-rank group is nn.BatchNorm2d on the rank's own rows,
    bit for bit, running statistics included: a launch with
    data_parallel off trains independent replicas, as JAX's does."""
    spec = group["spec"]
    with np.load(spec["bn"]) as z:
        x, scale, bias = z["x"], z["scale"], z["bias"]
    for r in range(WORLD):
        got = np.load(os.path.join(spec["out"], f"bn_{r}.npz"))
        want = torch.nn.BatchNorm2d(BN_SHAPE[1]).train()
        with torch.no_grad():
            want.weight.copy_(torch.from_numpy(scale))
            want.bias.copy_(torch.from_numpy(bias))
        rows = slice(r * BN_SHAPE[0] // WORLD, (r + 1) * BN_SHAPE[0] // WORLD)
        y = want(torch.from_numpy(x[rows])).detach().numpy()
        np.testing.assert_array_equal(got["y_local"], y)
        np.testing.assert_array_equal(got["mean_local"], want.running_mean.numpy())
        np.testing.assert_array_equal(got["var_local"], want.running_var.numpy())


def _rank_states(group, name):
    return [torch.load(os.path.join(group["spec"]["out"], f"{name}_state_{r}.pt"))
            for r in range(WORLD)]


def _assert_replicas_equal(states):
    a, b = states
    for which in ("after_1", "after_3"):
        for k, v in a[which].items():
            assert torch.equal(v, b[which][k]), (which, k)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k])), (i, k)


@pytest.mark.parametrize("name", ["iter", "accum"])
def test_two_ranks_train_as_jax_mesh_and_one_process(group, name):
    """3 steps of sr_task.main over 2 gloo ranks (per iteration, then
    grad_accum=2), each rank on its block of every (micro-)batch, the last
    step's valid rows all on rank 0: losses at rtol 1e-4 against JAX's
    SRTrainer over the 8-device mesh and against the port's one-process
    run; the state by test_torch_sr_train.py's rule against both (BN
    statistics at atol 1e-5 after step 1, 5e-4 after step 3); both ranks'
    parameters, BN statistics and Adam state equal bit for bit; BN's
    counters at one update a step, or under grad_accum one a micro-batch
    that is not all padding (2 after step 1, 5 after step 3)."""
    from test_torch_sr_train import _assert_state_close

    results, refs = group["results"], group["refs"]
    lr_rate = group["jcfg"]["lr"]
    losses = results[0][name]["losses"]
    assert len(losses) == SR_STEPS and results[1][name]["losses"] == []
    assert results[0][name]["mesh"] == WORLD
    states = _rank_states(group, name)
    _assert_replicas_equal(states)
    # BN updates: one a step, or one a micro-batch that is not all padding
    for which, n in zip(("after_1", "after_3"), BN_UPDATES[name]):
        assert {int(v) for k, v in states[0][which].items()
                if k.endswith("num_batches_tracked")} == {n}, which
    for ref in (refs[f"jax_{name}"], refs[f"one_{name}"]):
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
        for which, i, steps, atol in (("after_1", 0, 1, 1e-5), ("after_3", -1, SR_STEPS, 5e-4)):
            want = {k: v for k, v in ref["states"][i].items()
                    if not k.endswith("num_batches_tracked")}
            _assert_state_close(states[0][which], want, lr_rate, steps, stats_atol=atol)


def test_rank_zero_artifacts_and_per_rank_logs(group):
    """Checkpoints and TensorBoard files on rank 0 only (each rank in a
    work dir of its own); a log_rank{r}.txt on each."""
    r0, r1 = group["results"][0]["iter"], group["results"][1]["iter"]
    assert "latest.pth" in r0["ckpts"] and "epoch_0.pth" in r0["ckpts"]
    assert r1["ckpts"] == []
    assert r0["tb_files"] > 0 and r1["tb_files"] == 0
    assert r0["rank_log"] and r1["rank_log"]


def test_sharded_eval_equal_on_both_ranks_and_to_jax(group):
    """The eval after the 3 steps (test batches of 8 split 4 + 4 over the
    ranks; 12 rows, so the second batch lies on rank 0 alone) is the same
    on both ranks, and equals JAX's sharded eval over the 8-device mesh on
    the trained weights at rtol 1e-5."""
    import jax

    from conftest import make_toy_trainer
    from tactilesr_tpu.parallel.mesh import make_mesh
    from tactilesr_tpu.tasks import sr_task as jax_sr_task
    from tactilesr_torch.compat.torch_convert import convert_tactile_sr

    r0, r1 = group["results"][0]["iter"]["evals"], group["results"][1]["iter"]["evals"]
    assert r0 == r1
    lr_t, hr_t = group["test"]
    trained = _rank_states(group, "iter")[0]["after_3"]
    variables = jax.tree_util.tree_map(
        np.asarray, convert_tactile_sr(trained, pattern_layers=1, force_layers=1))
    t = make_toy_trainer(dict(group["jcfg"], test_batch_size=8), lr_t, hr_t, max_epochs=1,
                         mesh=make_mesh())
    t.state = t.state.replace(params=jax.device_put(variables["params"], t._repl),
                              batch_stats=jax.device_put(variables["batch_stats"], t._repl))
    want = jax_sr_task.build_eval_fn(t, {"LR": lr_t, "HR": hr_t})()
    for k, v in want.items():
        np.testing.assert_allclose(r0[k], v, rtol=1e-5, err_msg=k)


def test_eval_falls_back_to_replicated_when_the_test_batch_does_not_split(group):
    """test_batch_size 3 over 2 ranks: JAX's warning, and on each rank the
    metrics of the eval without a mesh, exactly."""
    for r in range(WORLD):
        res = group["results"][r]["eval_fallback"]
        assert res["warned"]
        assert res["fallback"] == res["plain"]


def test_scan_matches_per_iteration_and_resumes(group):
    """scan_epochs (uncaptured on the CPU) over the 2 ranks: the losses of
    the per-iteration run at rtol 1e-5; a resume from the shared work dir
    starts at the next epoch and trains it."""
    res = group["results"]
    np.testing.assert_allclose(res[0]["scan"]["losses"], res[0]["iter"]["losses"], rtol=1e-5)
    for r in range(WORLD):
        assert res[r]["resume"]["start_iter"] == SR_STEPS
    assert len(res[0]["resume"]["losses"]) == 2 * SR_STEPS
    assert "epoch_1.pth" in res[0]["resume"]["ckpts"]
    assert np.isfinite(res[0]["resume"]["losses"]).all()


def test_tpsf_recipe_over_two_ranks_matches_one_process(group):
    """One epoch of the tPSF recipe (plain physics on the CPU, f32) over
    the 2 ranks, each on 8 rows of every batch of 16: losses at rtol 1e-4
    against one process."""
    res = group["results"]
    assert res[0]["tpsf"]["mesh"] == WORLD
    want = group["refs"]["one_tpsf"]
    assert len(want) > 0
    np.testing.assert_allclose(res[0]["tpsf"]["losses"], want, rtol=1e-4)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.path.insert(0, ROOT)
        _worker(sys.argv[2])
