"""SNOB stand-in calibration harness (artifacts/figparity/SNOBPARITY.md).

Runs a SNOB-only landscape-exploration collection (1e6 objective fcalls,
1000 controllers, reference budgets) for a given transition and
sigma_train, characterises the collected set and the reference's SHIPPED
pipeline_nmplus2 snob set under the SAME MC sweep (sigma_sim =
sigma_train, 100 bootreps), and reports the two-sample KS statistic of
the RIM_1 distributions plus medians.

Usage (repo root):  python artifacts/figparity/snob_calibrate.py N OUT SIGMA
e.g. the calibration transition: ... 5 2 0.05; held-out: ... 6 5 0.05
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402


def collect_snob(n, out, sigma, c=1000, budget=int(1e6), exp_dir=None):
    from code_robchar_tpu.exp.experiment import Experiment
    exp_dir = exp_dir or f"/tmp/snobcal/{n}_{out}_{sigma}/experiments"
    os.makedirs(exp_dir, exist_ok=True)
    e = Experiment("snobcal", Nspin=n, inspin=0, outspin=out, runs=c,
                   noises=np.asarray([sigma]), fid_threshold=0.1,
                   ham_noisy=True, run_until_told_to_stop=True,
                   run_until_completion_its=budget, testing=True,
                   global_dir=exp_dir)
    e.models = ["snob"]
    t0 = time.time()
    e.singlerun_ccollector()
    d = json.load(open(e.filename))
    ours = np.asarray(d["snob"][str(sigma)]["controller"])
    print(f"[snobcal] collected {ours.shape} in {time.time() - t0:.0f}s")
    return ours


def rims_of(controllers, n, out, sigma, key, bootreps=100):
    import jax.numpy as jnp
    from code_robchar_tpu.mc.engine import mc_metric_sweep
    from code_robchar_tpu.ops import chain
    h0 = chain.xx_hamiltonian_real(n, dtype=jnp.float32)
    # use_pallas=None: ops/select.py picks the kernel for the platform
    md = mc_metric_sweep(h0, jnp.asarray(controllers, jnp.float32),
                         jnp.asarray([sigma], jnp.float32), key,
                         bootreps, 0, out)
    return np.asarray(md[r"$W(.,\delta(x-1))$"][0])


def main():
    import jax
    import scipy.stats
    n, out = int(sys.argv[1]), int(sys.argv[2])
    sigma = float(sys.argv[3]) if len(sys.argv) > 3 else 0.05

    shipped = json.load(open(
        f"/root/reference/experiments/pipeline_nmplus2/"
        f"ppo_spin_{n}_0-{out}_c_1000.le"))["snob"][str(sigma)]["controller"]
    shipped = np.asarray(shipped)

    ours = collect_snob(n, out, sigma)
    r_ours = rims_of(ours, n, out, sigma, jax.random.key(0))
    r_ship = rims_of(shipped, n, out, sigma, jax.random.key(0))
    stat, p = scipy.stats.ks_2samp(r_ours, r_ship)
    print(json.dumps({
        "transition": f"N={n} 0->{out}", "sigma_train": sigma,
        "ours_median_rim": round(float(np.median(r_ours)), 4),
        "shipped_median_rim": round(float(np.median(r_ship)), 4),
        "ks": round(float(stat), 4), "p": float(p),
        "n_each": [len(r_ours), len(r_ship)],
    }))


if __name__ == "__main__":
    main()
