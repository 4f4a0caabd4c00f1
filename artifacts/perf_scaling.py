"""Perf evidence: optimizer-zoo restart throughput and MC-sweep N-scaling
on the current kernels.  Prints a JSON line per measurement.

Usage (repo root, on the GPU): python artifacts/perf_scaling.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402


def fetch(x):
    import jax
    return jax.block_until_ready(x)


def main():
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.mc.engine import mc_metric_sweep
    from code_robchar_tpu.models import LBFGS, NMPlus, SNOB, Adam
    from code_robchar_tpu.ops import chain

    # ---- optimizer zoo at the production dispatch sizes ----------------
    # lbfgs/nmplus dispatch lane-recycled pools (lane_width-wide hardware
    # batch fed from the pool; see models/lbfgs.py); snob/adam have
    # fixed-length loops and stay at the 1024-lane batch
    n, out = 7, 6
    for cls in (LBFGS, NMPlus, SNOB, Adam):
        k_rest = 8192 if cls in (LBFGS, NMPlus) else 1024
        kw = dict(testing=True, fid_threshold=2.0, repeats=10**9,
                  run_until_told_to_stop=True,
                  run_until_completion_its=10**12,
                  landscape_exploration=True, save_topc=64)
        opt = cls(n, 0, out, **kw)
        keys = jax.random.split(jax.random.key(5), k_rest)
        res = opt._run_batch(jnp.asarray(opt.init_points(k_rest)), keys)
        fetch(res.fid)                       # compile
        t0 = time.perf_counter()
        res = opt._run_batch(jnp.asarray(opt.init_points(k_rest)),
                             jax.random.split(jax.random.key(7), k_rest))
        fetch(res.fid)
        dt = time.perf_counter() - t0
        print(json.dumps({"zoo": cls.name, "restarts_per_s":
                          round(k_rest / dt, 1), "batch": k_rest, "n": n}))

    # ---- MC fused-sweep N-scaling --------------------------------------
    for n in (4, 5, 6, 7, 8, 9, 10):
        h0 = chain.xx_hamiltonian_real(n, dtype=jnp.float32)
        ctrl = jax.random.uniform(jax.random.key(3), (10000, n + 1),
                                  jnp.float32, -10, 10)
        noises = jnp.linspace(0, 0.1, 11).astype(jnp.float32)
        g = lambda k: mc_metric_sweep(          # noqa: E731
            h0, ctrl, noises, k, 100, 0, n - 1)[r"$W(.,\delta(x-1))$"]
        fetch(g(jax.random.key(0)))          # compile
        t0 = time.perf_counter()
        out_ = [g(jax.random.key(2 + i)) for i in range(3)]
        fetch(out_[-1])
        dt = (time.perf_counter() - t0) / 3
        total = 11 * 10_000 * 100
        print(json.dumps({"mc_sweep_n": n, "hams_per_s":
                          round(total / dt, 1), "wall_s": round(dt, 3)}))


if __name__ == "__main__":
    main()
