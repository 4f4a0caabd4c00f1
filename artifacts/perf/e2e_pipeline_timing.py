"""End-to-end production-pipeline wall-time with compile amortisation.

Measures the full characterisation pipeline (the round-3 validation
workload: Experiment -> all four families at a 2e5-fcall budget across
three training sigmas -> .le store -> MC characterisation -> fig3e/fig5
renders) with PER-CELL timers, to quantify the round-3 compile-economics
work (models/base._PROGRAM_CACHE + the persistent XLA compilation cache;
see ARCHITECTURE.md "Compilation economics"):

- within a process the first cell of a family pays the XLA compile,
  every later sigma cell of that family reuses the compiled program;
- across processes the persistent cache turns the first-cell compile
  into a deserialize (run this script twice to see it).

Run from the repo root on the target device:
    python artifacts/perf/e2e_pipeline_timing.py [--fresh-compile-cache]

Prints one JSON line with per-phase and per-cell seconds.
"""

import json
import os
import shutil
import sys
import tempfile
import time

if "--fresh-compile-cache" in sys.argv:
    # measure the true cold-compile column: point the persistent cache at
    # an empty dir (JAX reads this before first device use)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="robchar_cc_")

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

N = int(os.environ.get("ROBCHAR_E2E_N", 5))
OUT = int(os.environ.get("ROBCHAR_E2E_OUT", 2))
C = int(os.environ.get("ROBCHAR_E2E_C", 1000))
BUDGET = int(float(os.environ.get("ROBCHAR_E2E_BUDGET", 2e5)))
NOISES_TRAIN = [0.0, 0.05, 0.1]


def main():
    from code_robchar_tpu.exp.experiment import Experiment

    exp_dir = tempfile.mkdtemp(prefix="robchar_e2e_")
    fig_dir = os.path.join(exp_dir, "figs")
    os.makedirs(fig_dir, exist_ok=True)
    cell_times = {}

    common = dict(Nspin=N, inspin=0, outspin=OUT, runs=C,
                  noises=np.asarray(NOISES_TRAIN), fid_threshold=0.1,
                  ham_noisy=True, run_until_told_to_stop=True,
                  run_until_completion_its=BUDGET, testing=True,
                  global_dir=exp_dir)

    def instrument(exp):
        """Wrap exp._make_model so every cell's run() is wall-timed."""
        orig_make = exp._make_model

        def timed_make(inits, model_name, noise):
            x = orig_make(inits, model_name, noise)
            run = x.run

            def timed_run():
                t = time.time()
                out = run()
                cell_times[f"{model_name}@{noise}"] = round(
                    time.time() - t, 2)
                return out
            x.run = timed_run
            return x

        exp._make_model = timed_make

    t_total = time.time()

    # ---- collection: per-cell timing via the Experiment's own loop ----
    t0 = time.time()
    e = Experiment("pipeline_e2e", **common)
    e.models = ["lbfgs", "nmplus", "snob"]
    instrument(e)
    e.singlerun_ccollector()

    d = json.load(open(e.filename))
    if "ppo" not in d:
        d["ppo"] = {}
        json.dump(d, open(e.filename, "w"))
    e2 = Experiment("pipeline_e2e", **common)
    e2.args["num_agents"] = 64
    e2.models = ["ppo"]
    instrument(e2)
    e2.singlerun_ccollector()
    t_collect = time.time() - t0

    # ---- MC characterisation + figures (the fig classes run and cache
    # the MC sweeps of the collected store internally, as the reference's
    # generate_fig* scripts do) ----
    from code_robchar_tpu.figs import ARIMGenerator, IndividualContComparisons
    t0 = time.time()
    kw = dict(Nspin=N, inspin=0, outspin=OUT,
              noises=np.linspace(0, 0.1, 11), bootreps=100,
              numcontrollers=C, filemarker=".le", fig_dir=fig_dir,
              global_experiments_directory=exp_dir)
    y = IndividualContComparisons("pipeline_e2e", **kw)
    y.plot_fig3e(noise_keys=[0.0], figname="e2e_fig3e")
    a = ARIMGenerator("pipeline_e2e", **kw)
    a.get_ARIM_plot(figname="e2e_fig5")
    t_figs = time.time() - t0

    out = {
        "workload": f"N={N} 0->{OUT}, {C} controllers/family, "
                    f"{BUDGET:.0e} fcalls, sigmas {NOISES_TRAIN}",
        "total_s": round(time.time() - t_total, 1),
        "collect_s": round(t_collect, 1),
        "mc_plus_figures_s": round(t_figs, 1),
        "cell_s": cell_times,
        "fresh_compile_cache": "--fresh-compile-cache" in sys.argv,
    }
    print(json.dumps(out))
    shutil.rmtree(exp_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
