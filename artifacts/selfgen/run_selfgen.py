"""From-scratch paper-pipeline artifact (round 2).

Regenerates one full transition of the paper WITHOUT touching any shipped
controller data: all four optimizer families search 1000 controllers each
at sigma_train in {0.0, 0.05, 0.1} with the reference's 1e6-fcall budget
(get_paper_data.sh:4-30 semantics), then the MC engine characterises the
resulting store and the figure stack renders fig3e/fig5-style outputs —
everything on the device, end-to-end.

Run from the repo root:  python artifacts/selfgen/run_selfgen.py
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
EXP_DIR = os.path.join(HERE, "experiments")
FIG_DIR = os.path.join(HERE, "paperfigs")
NOISES_TRAIN = [0.0, 0.05, 0.1]
# transition selectable from the CLI: `python run_selfgen.py 7 6`
N, OUT = (int(sys.argv[1]), int(sys.argv[2])) if len(sys.argv) > 2 else (5, 2)
C, BUDGET = 1000, int(1e6)


def collect():
    from code_robchar_tpu.exp.experiment import Experiment

    common = dict(Nspin=N, inspin=0, outspin=OUT, runs=C,
                  noises=np.asarray(NOISES_TRAIN), fid_threshold=0.1,
                  ham_noisy=True, run_until_told_to_stop=True,
                  run_until_completion_its=BUDGET, testing=True,
                  global_dir=EXP_DIR)

    t0 = time.time()
    e = Experiment("pipeline_selfgen", **common)
    e.models = ["lbfgs", "nmplus", "snob"]
    e.singlerun_ccollector()
    print(f"[selfgen] classic zoo done in {time.time() - t0:.0f}s")

    # ppo gets its own Experiment so num_agents can be set without
    # widening the other optimizers' constructor surface; respawn merges
    # it into the same .le store.  The respawn quirk (faithful to
    # noise_analysis.py:299-315) iterates the CHECKPOINT's model keys, so
    # a new model must be seeded into the JSON first.
    import json
    t0 = time.time()
    store_path = e.filename
    d = json.load(open(store_path))
    if "ppo" not in d:
        d["ppo"] = {}
        json.dump(d, open(store_path, "w"))
    e2 = Experiment("pipeline_selfgen", **common)
    e2.args["num_agents"] = 64
    e2.models = ["ppo"]
    e2.singlerun_ccollector()
    print(f"[selfgen] ppo done in {time.time() - t0:.0f}s")
    return e2.filename


def figures():
    from code_robchar_tpu.figs import (ARIMGenerator,
                                       IndividualContComparisons)

    noises_sim = np.linspace(0, 0.1, 11)
    kw = dict(Nspin=N, inspin=0, outspin=OUT, noises=noises_sim,
              bootreps=100, numcontrollers=C, filemarker=".le",
              fig_dir=FIG_DIR, global_experiments_directory=EXP_DIR)
    t0 = time.time()
    y = IndividualContComparisons("pipeline_selfgen", **kw)
    p1 = y.plot_figs_3_6_10_11_12(noise_keys=noises_sim[:6],
                                  figname=f"selfgen_fig6_N{N}_0-{OUT}")
    p2 = y.plot_fig3e(noise_keys=noises_sim[:1], figname=f"selfgen_fig3e_N{N}_0-{OUT}")
    a = ARIMGenerator("pipeline_selfgen", **kw)
    p3 = a.get_ARIM_plot(figname=f"selfgen_fig5_N{N}_0-{OUT}")
    print(f"[selfgen] figures in {time.time() - t0:.0f}s: {p1} {p2} {p3}")


if __name__ == "__main__":
    t0 = time.time()
    store = collect()
    print("[selfgen] store:", store)
    figures()
    print(f"[selfgen] TOTAL {time.time() - t0:.0f}s")
