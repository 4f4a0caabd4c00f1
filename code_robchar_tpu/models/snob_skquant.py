"""Exact-SNOBFIT adapter (optional; needs the reference's skquant stack).

The production ``models.snob.SNOB`` is a budget-matched surrogate
(sanctioned by SURVEY.md §7.4): its RIM distributions are calibrated to
the reference's shipped SNOBFIT controller sets (KS 0.05-0.10 on the
calibration transition) but retain a bounded, conservative-direction gap
on hard transitions (KS ~0.2 on N=6 0->5; SNOBPARITY.md).  This adapter
reproduces the reference's EXACT search instead: one host-side
``skquant.opt.minimize(method="snobfit")`` call per Sobol restart —
mirroring qnewton.py:818-835 with ``optset(maxmp=150, maxfail=100)``
(qnewton.py:823-827) and ``budget=300`` — driving this framework's
objective shims, with the reference's record/top-c/fcall semantics
(qnewton.py:862-928).  Any environment with the reference's dependency
stack can therefore produce exact-SNOBFIT controller sets and
re-validate the surrogate against them (VERDICT r3 next #3).

skquant/SQSnobFit is not among the installed dependencies and could not
be installed (verified rounds 3 and 5,
artifacts/figparity/skquant_install_attempt.log).  Since round 5 the
adapter therefore resolves its engine through ``_load_backend``: the
real skquant stack when installed, else the VENDORED implementation of
the published SNOBFIT algorithm (models/snobfit_core.py, written from
Huyer & Neumaier 2008) — so the exact branch-and-fit path executes for
real in this container; ``backend="skquant"`` forces the reference
stack and raises ImportError when absent.

The optimizer itself is host-side sequential by nature (SNOBFIT's
branch-and-fit driver is stateful Python/C++); only the objective
evaluations ride the JAX kernels.  This is a parity/validation tool,
not a production path — use ``models.SNOB`` on the device.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from code_robchar_tpu.models.base import ControlOptimizer
from code_robchar_tpu.utils.record import RunRecord, TopControllers


def _load_backend(backend: str = "auto"):
    """Resolve the SNOBFIT engine.

    - "skquant":  the reference's own stack (skquant + SQSnobFit);
      raises ImportError when absent.
    - "vendored": models/snobfit_core.py — the from-the-paper
      implementation of the published branch-and-fit algorithm
      (Huyer & Neumaier 2008), always available.
    - "auto":     skquant when installed, else vendored (this container
      has no egress and no skquant wheel —
      artifacts/figparity/skquant_install_attempt.log).

    Returns (namespace-with-minimize, optset, resolved_name)."""
    if backend in ("auto", "skquant"):
        try:
            from skquant import opt as skq      # noqa: F401
            from SQSnobFit import optset        # noqa: F401
            return skq, optset, "skquant"
        except ImportError as e:
            if backend == "skquant":
                raise ImportError(
                    "backend='skquant' requires the reference's optimizer "
                    "stack: pip install skquant SQSnobFit.  Use "
                    "backend='vendored' (published-algorithm "
                    "implementation, models/snobfit_core.py) or the "
                    "budget-matched surrogate models.SNOB "
                    "(SNOBPARITY.md documents the distributional deltas)."
                ) from e
    from code_robchar_tpu.models import snobfit_core
    return snobfit_core, snobfit_core.optset, "vendored"


class SNOBSkquant(ControlOptimizer):
    """Reference-exact SNOBFIT restarts through skquant (qnewton.py:770-928).

    Same constructor surface as the surrogate ``SNOB`` (base kwargs +
    ``budget``), same record/records protocol, same fcall accounting
    (300 objective evals per restart, x train_size under fixed-ham,
    qnewton.py:862-866)."""

    name = "snob"           # writes reference-named record files

    def __init__(self, *args, budget: int = 300, backend: str = "auto",
                 **kwargs):
        self._skq, self._optset, self.backend_name = _load_backend(backend)
        super().__init__(*args, **kwargs)
        self.budget = int(budget)
        if self.adaptive:
            raise NotImplementedError(
                "adaptive-shot billing is not wired for the skquant "
                "adapter (the paper pipeline never runs snob adaptive); "
                "use models.SNOB or adaptive=False")

    def run(self):
        """The reference SNOB.run control flow (qnewton.py:775-928):
        Sobol/uniform x0 per restart, skquant minimize, top-c update,
        first-hit vs budget stop, wall-clock AssertionError timeout."""
        skq, optset = self._skq, self._optset
        rr = RunRecord(landscape_exploration=self.landscape_exploration,
                       records_update_rate=self.records_update_rate,
                       run_until_completion_its=self.run_until_completion_its)
        self.record = rr.record
        self.records = rr.records
        top = TopControllers(self.save_topc)
        funccalls = 0
        start = rr.start_time

        def infidelity(x):
            if self.use_fixed_ham:
                return 1.0 - self.fidelity_ss_av(x)
            return 1.0 - self.fidelity_ss(x, noisy=self.fid_noisy,
                                          ham_noisy=self.ham_noisy)

        extra_kw = {}
        if self.backend_name == "vendored":
            # vendored-only extension: score each suggested batch in one
            # jitted lanes call (snobfit_core.minimize docstring —
            # semantically identical to the sequential loop).  Keys fold
            # the lane index, so noise draws match the batched-zoo
            # distributional-parity stance (SURVEY §7.4), not the
            # sequential next_key() stream.
            import jax

            from code_robchar_tpu.models import objectives
            infid_b = jax.jit(objectives.make_infidelity_batch(self.spec()))

            def objective_batch(xs):
                vals, _bills = infid_b(jnp.asarray(xs, self.HH.dtype),
                                       self.next_key())
                return np.asarray(vals, dtype=float)

            extra_kw["objective_batch"] = objective_batch

        options = optset(optin={"maxmp": 150, "maxfail": 100,
                                "verbose": False})
        for rep in range(self.repeats):
            x0 = np.asarray(self.init_points(1)[0], dtype=float)
            result, _history = skq.minimize(
                infidelity, x0, bounds=np.asarray(self.val_bounds,
                                                  dtype=float),
                budget=self.budget, method="snobfit", options=options,
                **extra_kw)
            fi = 1.0 - float(result.optval)
            x = np.asarray(result.optpar, dtype=float)

            # reported optimum is the min of the noisy history; the
            # noiseless re-evaluation feeds best_fid under noise
            # (qnewton.py:841-848, 886-889)
            true_fid = fi if self.use_fixed_ham else self.fidelity_ss(x)
            funccalls += self.budget * (self.train_size
                                        if self.use_fixed_ham else 1)

            def save_aux():
                rr.save(func_calls=funccalls, iterations=None,
                        repeats=rep, controller=x.tolist(),
                        best_fid=(true_fid if (self.ham_noisy or
                                               self.fid_noisy) else fi),
                        top=top if self.landscape_exploration else None)

            if not self.run_until_told_to_stop:
                if fi > self.fid_threshold:
                    save_aux()
                    if self.save:
                        self.save_record()
                    return fi
                # the wall-clock fail-safe guards BOTH stop modes, like
                # base.run's deadline.check (a `continue` above it would
                # leave threshold-mode runs unbounded)
                if time.time() - start > self.timeout:
                    print(f"timed out! {self.filename}")
                    raise AssertionError("timeout")
                continue

            crit = (fi >= self.fid_threshold
                    if rr.record["best_fid"] is None
                    else (True if self.landscape_exploration
                          else fi >= rr.record["best_fid"]))
            if crit:
                if self.landscape_exploration:
                    top.offer(fi, x.tolist())
                save_aux()
            # budget gate on THIS rep's billing — returning only on the
            # next rep would run one extra full SNOBFIT restart past the
            # budget (base.run returns as soon as billing crosses it).
            # None budget = run on the wall-clock timeout alone, like
            # base.run (base.py uses `or np.inf` for the same gate)
            completion = (funccalls + 1 >=
                          (self.run_until_completion_its or np.inf))
            if completion:
                return rr.record["best_fid"]
            if time.time() - start > self.timeout:
                print(f"timed out! {self.filename}")
                raise AssertionError("timeout")
        return rr.record["best_fid"]
