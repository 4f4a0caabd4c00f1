"""Readings that set a cell's correctness limits: the program's and the
control's, seed by seed, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 101 102 ... \\
        [--steps 3]

For each seed it builds the cell's driver, runs its set-up and ``--steps``
steps of the timed path at the cell's own size, reads what the
comparison reads (the program's, or lower, reading), then puts the
reference computed in bfloat16 in the program's place and reads the same
numbers (the control's, or upper, reading).  Each seed prints one JSON
line; a limit is then set between the largest program reading and the
smallest control reading (PERF.md gives both).  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time

from cell import ROOT, load_cell

if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def main(argv=None, root=ROOT):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    cell = load_cell(args.workload, root)

    import jax
    from cell import compile_cache_dir
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    import code_robchar_tpu  # noqa: F401
    from drivers import DRIVERS

    for seed in args.seeds:
        t0 = time.perf_counter()
        d = DRIVERS[cell.traffic["driver"]](cell, seed)
        d.setup()
        for _ in range(args.steps):
            d.step()
        d.release()
        program = {name: v for name, v, _ in d.check()}
        control = d.control()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
