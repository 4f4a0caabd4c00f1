"""The general traffic generators: one per kind of work the program does.

A traffic file names its driver (``"driver"``) and gives its
parameters; the configuration file gives the problem.  Each driver

- ``setup()``: makes the inputs from the seed (on the device, in one
  jitted call where it makes arrays) and runs the exact work of one step
  once, so that every program the window uses is compiled or loaded from
  the cache before the window opens;
- ``step() -> work``: one unit of the timed path, waited for, with the
  amount of work it did in the unit of the cell's end-to-end rate;
- ``release()``: drops its device state once the window has closed;
- ``check() -> [(name, value, limit)]``: the comparison with the plain
  float64 reference (``reference/``) of what the timed steps returned.

``characterise`` drives ``mc.engine.characterise`` (the Monte-Carlo
robustness sweep with the fused metric reduction) over a lattice of
noise levels x controllers x bootstrap reps, optionally over a device
mesh.  ``collect`` drives one optimizer family's ``run()`` as the
experiment driver's landscape-exploration collection constructs it.
"""

from __future__ import annotations

import numpy as np

from reference import chain as ref

#: fidelity tolerance of the yield comparison: a float32 transfer phase
#: T * lambda carries about 30 * 12 * 6e-8 = 2e-5 of rounding, so a
#: sample that close to a yield threshold may fall on either side of it;
#: five times that is allowed before a yield counts as wrong
YIELD_TOL = 1e-4


def _seed_words(seed: int, what: str) -> int:
    """A 32-bit seed for one named input stream of a run."""
    ss = np.random.SeedSequence([seed % 2 ** 63, *map(ord, what)])
    return int(ss.generate_state(1)[0])


def drift(config) -> np.ndarray:
    return ref.drift(config["nspin"], config["coupling"])


class Characterise:
    """``engine.characterise(..., return_fids=False, mesh=...)`` back to
    back.  Every call of a run uses the run's key: the call is the whole
    characterisation of one controller set, and a key that changes would
    make the sharded path, which takes the key into its program, compile
    in every call."""

    def __init__(self, cell, seed: int):
        self.cfg, self.tr, self.seed = cell.config, cell.traffic, seed
        self.n = self.cfg["nspin"]
        self.num_c = int(self.tr["controllers"])
        self.bootreps = int(self.tr["bootreps"])
        lv = self.tr["noise_levels"]
        self.noises = np.linspace(lv["start"], lv["stop"], lv["num"])
        self.mesh_devices = int(self.tr.get("mesh_devices", 1))
        self.work = len(self.noises) * self.num_c * self.bootreps
        self.kept = {}
        self._rng = np.random.default_rng(_seed_words(seed, "sample"))
        self._cells = None
        self.calls = 0

    def setup(self):
        import jax
        import jax.numpy as jnp
        from code_robchar_tpu.mc import engine
        from code_robchar_tpu.parallel import mesh as pmesh

        n, lo, hi = self.n, self.cfg["bias_bounds"], self.cfg["time_bounds"]
        self.key = jax.random.key(np.uint32(_seed_words(self.seed, "key")))
        k_ctrl = jax.random.key(np.uint32(_seed_words(self.seed, "ctrl")))
        mesh = pmesh.make_mesh(self.mesh_devices) \
            if self.mesh_devices > 1 else None

        @jax.jit
        def make_controllers(k):
            u = jax.random.uniform(k, (self.num_c, n + 1), jnp.float32)
            low = jnp.asarray([lo[0]] * n + [hi[0]], jnp.float32)
            high = jnp.asarray([lo[1]] * n + [hi[1]], jnp.float32)
            return low + (high - low) * u

        ctrl = make_controllers(k_ctrl)
        if mesh is not None:
            ctrl = pmesh.shard_batch(mesh, ctrl)
        h0 = jnp.asarray(drift(self.cfg), jnp.float32)
        noises = jnp.asarray(self.noises, jnp.float32)
        self.ctrl = ctrl

        def call():
            return engine.characterise(
                h0, ctrl, noises, self.key, self.bootreps,
                self.cfg["in_spin"], self.cfg["out_spin"],
                alpha=self.cfg["alpha"], return_fids=False, mesh=mesh)

        self._call = call
        jax.block_until_ready(call())

    def step(self) -> float:
        import jax
        out = jax.block_until_ready(self._call())
        # keep the first call, the latest, and one drawn uniformly from
        # the seed among all calls (a reservoir of one)
        self.calls += 1
        if self.calls == 1:
            self.kept["first"] = out
        if self._rng.random() < 1.0 / self.calls:
            self.kept["drawn"] = out
        self.kept["last"] = out
        return float(self.work)

    def release(self):
        import jax
        self.key_words = np.asarray(jax.random.key_data(self.key))
        self.ctrl_host = np.asarray(jax.device_get(self.ctrl), np.float64)
        self.outputs = {k: {m: np.asarray(jax.device_get(v), np.float64)
                            for m, v in out.items()}
                        for k, out in self.kept.items()}
        self.kept = {}
        self.ctrl = self._call = None

    # ------------------------------------------------------------ check
    def sample_cells(self):
        """(l, c) cells to compare: every noise level of the controllers
        with the highest noiseless float64 fidelity (where the metrics
        are most sensitive), and cells drawn from the seed, spread over
        equal blocks of the controller axis (and so over every shard of a
        mesh)."""
        if self._cells is None:
            rng = np.random.default_rng(_seed_words(self.seed, "cells"))
            h0 = drift(self.cfg)
            f0 = ref.controller_fidelity(h0, self.ctrl_host,
                                         self.cfg["in_spin"],
                                         self.cfg["out_spin"])
            top = np.argsort(-f0)[:self.tr["check_top_controllers"]]
            L = len(self.noises)
            cells = [(l, int(c)) for c in top for l in range(L)]
            for b in np.array_split(np.arange(self.num_c),
                                    self.tr["check_blocks"]):
                for _ in range(self.tr["check_cells_per_block"]):
                    cells.append((int(rng.integers(L)), int(rng.choice(b))))
            self._cells = cells
        return self._cells

    def reference_fids(self, cells, precision="float64"):
        h0 = drift(self.cfg)
        B, C, n = self.bootreps, self.num_c, self.n
        l = np.repeat([c[0] for c in cells], B)
        c = np.repeat([c[1] for c in cells], B)
        b = np.tile(np.arange(B), len(cells))
        gid = ((l * C + c) * B + b).astype(np.uint32)
        # the program draws in float32: the widths are float32 numbers
        sig = self.noises.astype(np.float32).astype(np.float64)[l]
        x = self.ctrl_host[c]
        h = ref.perturbed_hamiltonians(h0, tuple(self.key_words), gid, sig, x)
        f = ref.transfer_fidelity(h, x[:, n], self.cfg["in_spin"],
                                  self.cfg["out_spin"], precision)
        return f.reshape(len(cells), B)

    def gap(self, values: dict, cells, fids) -> float:
        """Widest gap of the metric values ``values`` {name: (cells,)}
        from the reference metrics of ``fids``; a yield counts only by
        how far it lies outside what fidelities within YIELD_TOL of the
        reference's could give."""
        alpha = self.cfg["alpha"]
        want = ref.metric_values(fids, alpha)
        yb = ref.yield_bounds(fids, alpha, YIELD_TOL)
        worst = 0.0
        for name, r in want.items():
            v = values[name]
            if name in yb:
                lo, hi = yb[name]
                g = np.maximum(np.maximum(lo - v, v - hi), 0.0)
            else:
                g = np.abs(v - r)
            worst = max(worst, float(np.max(g)))
        return worst

    def program_values(self, out, cells):
        li = np.array([c[0] for c in cells])
        ci = np.array([c[1] for c in cells])
        return {name: arr[li, ci] for name, arr in out.items()}

    def check(self):
        cells = self.sample_cells()
        fids = self.reference_fids(cells)
        gaps = [self.gap(self.program_values(out, cells), cells, fids)
                for out in self.outputs.values()]
        self.failed = sum(g > self.tr["limits"]["metric_gap"] for g in gaps)
        return [("metric_gap", max(gaps), self.tr["limits"]["metric_gap"])]

    def control(self):
        """The control's reading: the reference computed in bfloat16 in
        the program's place, compared as the program is."""
        cells = self.sample_cells()
        fids = self.reference_fids(cells)
        low = self.reference_fids(cells, "bfloat16")
        values = ref.metric_values(low, self.cfg["alpha"])
        return {"metric_gap": self.gap(values, cells, fids)}


class Collect:
    """Whole ``run()`` calls of one optimizer family, back to back, each
    on a seed of its own, built as the landscape-exploration collection
    builds them: run until the function-call budget is billed, keeping
    the best ``save_topc`` controllers."""

    def __init__(self, cell, seed: int):
        self.cfg, self.tr, self.seed = cell.config, cell.traffic, seed
        self.n = self.cfg["nspin"]
        self.runs = []
        self.calls = 0

    def run_seed(self, i: int) -> int:
        return _seed_words(self.seed, f"run{i}") % 2 ** 31

    def model(self, run_seed: int):
        from code_robchar_tpu.models import MODEL_REGISTRY
        from code_robchar_tpu.ops.sobol import SobolStream

        tr, cfg = self.tr, self.cfg
        args = dict(nspin=self.n, in_spin=cfg["in_spin"],
                    out_spin=cfg["out_spin"], bmin=cfg["bias_bounds"][0],
                    bmax=cfg["bias_bounds"][1],
                    max_time=cfg["time_bounds"][1], timeout=1080000,
                    draws=10, fid_noisy=False, ham_noisy=False,
                    verbose=False, testing=False,
                    run_until_completion_its=tr["fcall_budget"],
                    run_until_told_to_stop=True, use_fixed_ham=False,
                    opt_train_size=100, records_update_rate=1e5,
                    landscape_exploration=True, save_topc=tr["save_topc"],
                    seed=run_seed)
        args.update(tr.get("model_args", {}))
        x = MODEL_REGISTRY[tr["family"]](**args)
        x.fid_threshold = tr["fid_threshold"]
        if tr["family"] == "ppo":
            x.env.noise = tr["sigma_train"]
        else:
            x.noise = tr["sigma_train"]
        if hasattr(x, "_sobol_stream"):
            # restart points: the Sobol sequence, scrambled from the seed
            x._sobol = SobolStream(self.n + 1, scramble=True, seed=run_seed)
        return x

    def setup(self):
        self.model(self.run_seed(-1)).run()

    def step(self) -> float:
        x = self.model(self.run_seed(self.calls))
        x.run()
        rec = x.record
        self.calls += 1
        self.runs.append(dict(func_calls=rec["func_calls"] or 0,
                              best_fid=rec["best_fid"],
                              controller=rec["controller"],
                              controllers=rec.get("controllers") or []))
        return float(rec["func_calls"] or 0)

    def release(self):
        pass

    # ------------------------------------------------------------ check
    def _bounds(self):
        lo, hi = self.cfg["bias_bounds"], self.cfg["time_bounds"]
        return [tuple(lo)] * self.n + [tuple(hi)]

    def top_kept(self, run):
        """The run's kept controllers with the highest float64 fidelity:
        the converged optima a collection is for."""
        xs = np.asarray(run["controllers"], np.float64).reshape(
            -1, self.n + 1)
        f = ref.controller_fidelity(drift(self.cfg), xs, self.cfg["in_spin"],
                                    self.cfg["out_spin"])
        return xs[np.argsort(-f)[:self.tr["check_top_kept"]]]

    def readings(self, bests, tops):
        """``bests``: per run, (reported best fidelity, its controller);
        ``tops``: per run, controllers that it kept.  best_fid_gap: how
        far a reported fidelity lies from the float64 fidelity of its
        controller; top_ascent: how much the reference optimiser still
        gains from the kept controllers, which the run's optimiser had
        declared converged (the median over a run's, the largest over
        runs)."""
        h0 = drift(self.cfg)
        i, o = self.cfg["in_spin"], self.cfg["out_spin"]
        gap, ascent = 0.0, 0.0
        for fid, x in bests:
            if fid is None or x is None:
                return {"best_fid_gap": np.inf, "top_ascent": np.inf}
            f = float(ref.controller_fidelity(h0, np.asarray(x, np.float64),
                                              i, o))
            gap = max(gap, abs(float(fid) - f))
        for xs in tops:
            if not len(xs):
                return {"best_fid_gap": gap, "top_ascent": np.inf}
            # the median: a restart the optimiser stops at its iteration
            # cap is kept unconverged, and a few such are no fault
            ascent = max(ascent, float(np.median(
                [ref.ascent_gain(h0, x, i, o, self._bounds()) for x in xs])))
        return {"best_fid_gap": gap, "top_ascent": ascent}

    def check(self):
        lim = self.tr["limits"]
        budget = float(self.tr["fcall_budget"])
        read = self.readings([(r["best_fid"], r["controller"])
                              for r in self.runs],
                             [self.top_kept(r) for r in self.runs])
        read["budget_short"] = max(
            (max(0.0, budget - 1 - r["func_calls"]) for r in self.runs),
            default=budget)
        self.failed = sum(
            r["best_fid"] is None or r["func_calls"] + 1 < budget
            for r in self.runs)
        # the traffic's limits name the numbers compared: a family whose
        # kept controllers need not be stationary points (a
        # derivative-free search) leaves top_ascent out
        return [(k, read[k], lim[k]) for k in
                ("best_fid_gap", "top_ascent", "budget_short") if k in lim]

    def control(self):
        """The control's readings: the reference in bfloat16 in the
        program's place.  For each run of the window it collects from
        the first ``control_restarts`` of the same restart points
        (SciPy's L-BFGS-B on the bfloat16 fidelity), keeps its best by
        that fidelity, and is compared as the runs are."""
        from scipy.stats import qmc
        h0 = drift(self.cfg)
        i, o = self.cfg["in_spin"], self.cfg["out_spin"]
        bounds = self._bounds()
        lo = np.array([b[0] for b in bounds])
        hi = np.array([b[1] for b in bounds])
        bests, tops = [], []
        for run in range(max(len(self.runs), 1)):
            starts = qmc.Sobol(self.n + 1, scramble=True,
                               seed=self.run_seed(run)).random(
                                   self.tr["control_restarts"])
            xs = np.array([ref.local_optimum(h0, lo + (hi - lo) * u, i, o,
                                             bounds, precision="bfloat16")
                           for u in starts])
            low = ref.controller_fidelity(h0, xs, i, o, "bfloat16")
            order = np.argsort(-low)
            bests.append((float(low[order[0]]), xs[order[0]]))
            tops.append(xs[order[:self.tr["check_top_kept"]]])
        return self.readings(bests, tops)


DRIVERS = {"characterise": Characterise, "collect": Collect}
