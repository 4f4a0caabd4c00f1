"""Smoke run of the characterisation and collection path on one GPU.

Run from the root of the repository, on a machine with an NVIDIA GPU:

    python chip_smoke.py               # the three phases below, one card
    python chip_smoke.py --kernel-ab   # XLA against kernel timings only
    python chip_smoke.py --four-gpus   # sharded against unsharded only

Default phases, all in this one process:

1. kernels: every Pallas Jacobi kernel compiled for the card at n = 4, 7
   and 10 and batch widths 1024, 1153 and the MC chunk, each compared
   with the f64 ``jnp.linalg.eigh`` reference on the host CPU device;
2. north star: ``engine.characterise`` at N = 7 over 10,000 controllers
   x 11 noise levels x 100 bootstrap reps, with the RIM of 200
   controllers compared with the f64 host reference on the same draws;
3. pipeline: the ``collect`` driver for the 7 -> 6 transition (five
   families, 1000 controllers; cuts below), then ``MCDataSim`` at
   11 x 1000 x 100 and ARIM over the collected controllers.

Every line before the last reports a check or a phase (compile and run
seconds, errors beside their tolerances, peak device memory) and the
card's name and power limit.  The last line is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.  Without a GPU, or when any phase
fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: phase 1 widths: the zoo / PPO batch, an odd width, the MC chunk
KERNEL_NS = (4, 7, 10)
#: the ``collect`` cuts of phase 3, against the paper's
#: get_paper_data.sh run (11 training noise levels, 1e6 calls per cell):
#: one training noise level (0) and 1e5 calls per family
COLLECT_CUTS = {"noise_res": 1, "run_until_completion_its": 100_000}
EXP_NAME = "chip_smoke_collect"


def card_identity() -> str:
    """``name, power.limit`` of the first card, read by a child process
    that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def require_gpu(devices) -> None:
    """Refuse to run on anything but GPUs: this script measures the
    card and has no CPU fallback."""
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{platforms}")


def require_checkout() -> None:
    """The package must come from the checkout this script sits in."""
    import code_robchar_tpu
    pkg = os.path.dirname(os.path.abspath(code_robchar_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"code_robchar_tpu imported from {pkg}, not from "
                         f"the checkout at {HERE}")


def report(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def peak_bytes() -> int:
    import jax
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def timed(fn, *args, **kwargs):
    """(result, seconds) of one call, waited for on the device."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def phase_kernels() -> bool:
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.ops import kernel_check as kc

    ok = True
    for kind in kc.KINDS:
        for n in KERNEL_NS:
            for b in (1024, 1153, engine.DEFAULT_CHUNK["triton"]):
                t0 = time.perf_counter()
                row = kc.check_kernel(kind, n, b)   # compiles, runs once
                check_s = time.perf_counter() - t0
                inputs = kc.make_inputs(kind, n, b)
                _, run_s = timed(kc.run_kernel, kind, inputs, 0, n - 1)
                report("kernel", check_s=round(check_s, 3), run_s=run_s,
                       **row)
                ok &= row["ok"]
    report("kernels", ok=ok, peak_bytes_in_use=peak_bytes())
    return ok


def northstar_inputs(n=7, num_c=10_000, num_l=11, seed=0):
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.ops import chain

    rng = np.random.default_rng(seed)
    h0 = chain.xx_hamiltonian_real(n, dtype=jnp.float32)
    ctrl = np.column_stack([rng.uniform(-10, 10, (num_c, n)),
                            rng.uniform(0, 30, num_c)]).astype(np.float32)
    noises = np.linspace(0, 0.1, num_l).astype(np.float32)
    return h0, ctrl, noises, jax.random.key(seed)


RIM = r"$W(.,\delta(x-1))$"


def phase_northstar(n=7, num_c=10_000, bootreps=100, checked=200) -> bool:
    import jax.numpy as jnp
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.ops import kernel_check as kc

    h0, ctrl, noises, key = northstar_inputs(n, num_c)

    def run():
        return engine.characterise(h0, jnp.asarray(ctrl),
                                   jnp.asarray(noises), key, bootreps, 0,
                                   n - 1, return_fids=False)
    _, first = timed(run)
    md, run_s = timed(run)
    rims = np.asarray(md[RIM])
    ref = kc.reference_rims(h0, ctrl[:checked], noises, key, bootreps, 0,
                            n - 1, c_global=len(ctrl))
    err = float(np.max(np.abs(rims[:, :checked] - ref)))
    finite = all(bool(np.all(np.isfinite(np.asarray(v))))
                 for v in md.values())
    ok = finite and err <= kc.FID_TOL
    hams = len(noises) * len(ctrl) * bootreps
    report("northstar", ok=ok, compile_s=round(first - run_s, 3),
           run_s=round(run_s, 3), hamiltonians_per_s=round(hams / run_s),
           rim_err_abs=err, tol_abs=kc.FID_TOL, controllers_checked=checked,
           metrics_finite=finite, peak_bytes_in_use=peak_bytes())
    return ok


def phase_pipeline(n=7, out=6, num_c=1000, cuts=COLLECT_CUTS) -> bool:
    import jax.numpy as jnp
    from code_robchar_tpu.exp import drivers
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.mc.datasim import MCDataSim

    algos = ("ppo", "lbfgs", "nmplus", "snob", "adam")
    exp_dir = os.path.join("experiments", EXP_NAME)
    shutil.rmtree(exp_dir, ignore_errors=True)
    argv = ["collect", "--exp_name", EXP_NAME, "--nspin", str(n),
            "--inspin", "0", "--outspin", str(out),
            "--num_controllers", str(num_c), "--algos", ",".join(algos)]
    for flag, value in cuts.items():
        argv += [f"--{flag}", str(value)]
    t0 = time.perf_counter()
    drivers.main(argv)
    collect_s = time.perf_counter() - t0

    sim = MCDataSim(experiment_name=EXP_NAME, Nspin=n, inspin=0,
                    outspin=out, noises=np.linspace(0, 0.1, 11),
                    bootreps=100, training_noise="0.0",
                    numcontrollers=num_c, filemarker=".le")
    counts = {a: len(sim.controllers[a][sim._algo_noise_key(a, "0.0")]
                     ["controller"]) for a in algos}
    fids, fid_s = timed(sim.get_fid_dists)
    metrics, metric_s = timed(sim.get_metrics_dict)
    ok = sorted(sim.algos) == sorted(algos)
    arims = {}
    for algo in algos:
        f = np.asarray(fids[algo])
        valid = ~np.isnan(f[0, :, 0])
        rims = np.asarray(metrics[algo][RIM], float)[:, valid]
        arims[algo] = [round(float(a), 6) for a in
                       engine.arim_from_rims(jnp.asarray(rims))]
        in_range = bool(np.all(np.isfinite(rims)) and
                        np.all((rims >= 0) & (rims <= 1)) and
                        np.all(np.isfinite(f[:, valid])))
        ok &= (f.shape == (11, num_c, 100) and counts[algo] > 0 and
               in_range and bool(np.all(np.isfinite(arims[algo]))))
    mc_files = sorted(os.listdir(exp_dir))
    report("pipeline", ok=ok, collect_s=round(collect_s, 3),
           characterise_s=round(fid_s, 3), metrics_s=round(metric_s, 3),
           cuts=cuts, controllers=counts, arim=arims,
           files=mc_files, peak_bytes_in_use=peak_bytes())
    shutil.rmtree(exp_dir, ignore_errors=True)
    return ok


def kernel_ab() -> bool:
    """Timings of the GPU paths at the shapes the cells use, in turns."""
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.models.ppo import PPO_en
    from code_robchar_tpu.ops import chain, pallas_jacobi as pj, realform

    def best(fn, *args, reps=5):
        jax.block_until_ready(fn(*args))
        return min(timed(fn, *args)[1] for _ in range(reps))

    # MC sweep at N = 7: lanes, cuSOLVER eigh, kernel; and the chunk
    n, bootreps = 7, 100
    h0, ctrl, noises, key = northstar_inputs(n, num_c=1000)
    ctrl = jnp.asarray(ctrl)
    noises = jnp.asarray(noises)
    hams = len(noises) * ctrl.shape[0] * bootreps
    variants = {"xla_lanes": dict(use_jacobi=True, use_pallas=False),
                "cusolver_eigh": dict(use_jacobi=False, use_pallas=False),
                "pallas_triton": dict(use_jacobi=True, use_pallas=True)}
    for chunk in (16384, 65536, 262144):
        for name, kw in list(variants.items()) * 2:
            if name != "pallas_triton" and \
                    chunk != engine.DEFAULT_CHUNK["triton"]:
                continue
            s = best(lambda: engine.mc_metric_sweep(
                h0, ctrl, noises, key, bootreps, 0, n - 1, chunk=chunk,
                **kw), reps=3)
            report("ab_mc_sweep", variant=name, chunk=chunk, seconds=s,
                   hamiltonians_per_s=round(hams / s))

    # zoo exact gradient at 1024 restarts and PPO env physics at 1024
    h0r = chain.xx_hamiltonian_real(n, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    xs = jnp.asarray(np.column_stack([rng.uniform(-10, 10, (1024, n)),
                                      rng.uniform(0, 30, 1024)]),
                     jnp.float32)
    a = jnp.broadcast_to(h0r[:, :, None], (n, n, 1024)) + \
        jnp.eye(n)[:, :, None] * xs[:, :n].T[None]
    t = jnp.abs(xs[:, n])
    grad = {"xla_lanes": jax.jit(lambda x: realform.
                                 infidelity_and_gradient_sym_lanes(
                                     h0r, x, 0, n - 1)),
            "pallas_triton": jax.jit(lambda x: pj.
                                     infidelity_and_gradient_sym_pallas(
                                         h0r, x, 0, n - 1))}
    amp = {"xla_lanes": jax.jit(lambda a, t: realform.
                                transfer_amp_sym_lanes(a, t, 0, n - 1, 4)),
           "pallas_triton": jax.jit(lambda a, t: pj.transfer_amp_sym_pallas(
               a, t, 0, n - 1, 4))}
    for name in ("xla_lanes", "pallas_triton", "pallas_triton",
                 "xla_lanes"):
        report("ab_zoo_grad", variant=name, batch=1024,
               seconds=best(grad[name], xs))
        report("ab_env_amp", variant=name, batch=1024, sweeps=4,
               seconds=best(amp[name], a, t))

    # one PPO epoch at 1024 agents (N = 7, 500 steps, 200 + 200 updates):
    # rollout, update and critic apart
    agents = 1024
    ppo = PPO_en(n, 0, n - 1, testing=True, fid_threshold=0.0,
                 ham_noisy=True, run_until_told_to_stop=True,
                 landscape_exploration=True, num_agents=agents,
                 rollout_sweeps=4)
    st = jax.vmap(ppo._init_agent)(jax.random.split(jax.random.key(0),
                                                   agents))
    for label, pi_iters, v_iters in (("epoch", 200, 200),
                                     ("rollout_only", 0, 0),
                                     ("critic_only", 0, 200)):
        fn = ppo._build_epoch(500, 0.2, 3e-3, 1e-3, 1000, pi_iters,
                              v_iters, 0.01)
        (_, out), first = timed(fn, st)
        s = min(timed(fn, st)[1] for _ in range(3))
        report("ab_ppo_epoch", part=label, agents=agents,
               compile_s=round(first - s, 3), seconds=s,
               pi_iters_mean=float(np.mean(np.asarray(out.pi_iters))),
               env_steps_per_s=round(agents * 500 / s))
    return True


def four_gpus(num_c=10_000, restarts=4096) -> bool:
    """Sharded against unsharded on a 4-card mesh: the fused MC metric
    sweep at the north-star lattice and one L-BFGS restart batch."""
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.models import LBFGS
    from code_robchar_tpu.parallel import make_mesh, sharded_mc_metrics
    from code_robchar_tpu.parallel import mesh as pmesh

    if len(jax.devices()) != 4:
        raise SystemExit(f"--four-gpus needs 4 cards, found "
                         f"{len(jax.devices())}")
    mesh = make_mesh(4)
    n, bootreps = 7, 100
    h0, ctrl, noises, key = northstar_inputs(n, num_c)
    ctrl, noises = jnp.asarray(ctrl), jnp.asarray(noises)
    one, one_s = timed(engine.mc_metric_sweep, h0, ctrl, noises, key,
                       bootreps, 0, n - 1)
    one, one_s = timed(engine.mc_metric_sweep, h0, ctrl, noises, key,
                       bootreps, 0, n - 1)
    sharded = lambda: sharded_mc_metrics(mesh, h0, ctrl, noises, key,
                                         bootreps, 0, n - 1)
    timed(sharded)
    four, four_s = timed(sharded)
    diff = max(float(np.max(np.abs(np.asarray(one[k]) -
                                   np.asarray(four[k])))) for k in one)
    # each element's draws and solve are per-element, so the sharded
    # sweep should match bit for bit; the bound only guards the report
    ok = diff <= 1e-6
    report("four_gpus_mc", ok=ok, max_abs_diff=diff, bitwise=diff == 0.0,
           one_card_s=one_s,
           four_card_s=four_s, lattice=[len(noises), ctrl.shape[0],
                                        bootreps])

    opt = LBFGS(n, 0, n - 1, testing=True, fid_threshold=2.0,
                repeats=10**9, run_until_told_to_stop=True,
                run_until_completion_its=10**12,
                landscape_exploration=True, save_topc=64)
    k = restarts
    x0s = jnp.asarray(opt.init_points(k))
    keys = jax.random.split(jax.random.key(7), k)
    plain = opt._run_batch(x0s, keys)
    plain, plain_s = timed(opt._run_batch, x0s, keys)
    opt.mesh = mesh
    xs_sh = pmesh.shard_batch(mesh, x0s)
    ks_sh = pmesh.shard_batch(mesh, keys)
    opt._run_batch_sharded(xs_sh, ks_sh)
    shard, shard_s = timed(opt._run_batch_sharded, xs_sh, ks_sh)
    pf, sf = np.asarray(plain.fid), np.asarray(shard.fid)
    # restarts are statistically, not bitwise, equivalent under
    # re-blocking (parallel/mesh.build_sharded_batch_fn): compare the
    # outcome distribution
    same = abs(float(np.median(pf)) - float(np.median(sf)))
    lb_ok = bool(np.all(np.isfinite(sf)) and same <= 0.02)
    report("four_gpus_lbfgs", ok=lb_ok, restarts=k,
           median_fid_one=float(np.median(pf)),
           median_fid_four=float(np.median(sf)), one_card_s=plain_s,
           four_card_s=shard_s)
    return ok and lb_ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--kernel-ab", action="store_true",
                      help="time XLA against the kernels, nothing else")
    mode.add_argument("--four-gpus", action="store_true",
                      help="sharded against unsharded on 4 cards only")
    args = p.parse_args(argv)

    import jax
    require_gpu(jax.devices())
    require_checkout()
    print(f"card: {card_identity()}", flush=True)

    if args.kernel_ab:
        phases = [("kernel_ab", kernel_ab)]
    elif args.four_gpus:
        phases = [("four_gpus", four_gpus)]
    else:
        phases = [("kernels", phase_kernels),
                  ("northstar", phase_northstar),
                  ("pipeline", phase_pipeline)]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            passed = fn()
        except Exception:
            traceback.print_exc()
            passed = False
        report(name, ok=passed, seconds=round(time.perf_counter() - t0, 3))
        ok &= passed
    if not ok:
        print("chip_smoke: FAILED", flush=True)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
