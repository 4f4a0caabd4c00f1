"""SNOB: budget-matched stable-noise global search (SNOBFIT-class).

Reference: the SNOB subclass (qnewton.py:770-928) delegates to
skquant/SQSnobFit's SNOBFIT — branch-and-fit: a mix of local quadratic-model
exploitation points and global exploration points, 300-eval budget per
restart with optset(maxmp=150, maxfail=100).

No SNOBFIT implementation exists for JAX, and SURVEY.md §7.4 sanctions "a
faithful surrogate with identical fcall/record semantics".  This stand-in
keeps SNOBFIT's defining structure — each round proposes a *mixed batch* of
(a) a local point from a model fitted to SCATTERED past evaluations (like
SNOBFIT's neighbor fits: a noisy linear least-squares gradient of the last
round's points, NOT clean finite differences) and (b) space-filling
exploration points — with exactly matched budget accounting (300 objective
evals per restart, billed x train_size under fixed-ham, qnewton.py:862-866):

  round r: evaluate q=10 candidates =
    - 1 "class-1/2" model point (trust-radius step along the scattered fit),
    - 2 "class-3" Gaussian jitters around the incumbent,
    - 7 "class-4/5" exploration points uniform in the box.

The mix and trust-radius dynamics are calibrated against the reference's
SHIPPED snob controller sets: on the N=5 0->2 sigma_train=0.05 transition
of pipeline_nmplus2, the top-1000 RIM distribution of a 1e6-fcall run
matches the shipped set with a two-sample KS statistic of ~0.07 (p ~ 0.03,
n=1000 each; down from 0.45 before round-2 calibration) — guarded by
tests/test_reference_interop.py::test_snob_calibration_ks_guardrail
(KS < 0.15 on a budget-scaled replica; the held-out N=6 0->5 gap is
recorded as an xfail there).  Ranking parity: restarts are ranked
by SNOBFIT's *reported optimum* 1 - optval, i.e. the min over the noisy
evaluation history (qnewton.py:836-838), not a fresh evaluation.

All restarts advance in lockstep (vmap over a fori_loop of rounds); every
candidate in a round is one vmapped objective batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from code_robchar_tpu.models import objectives
from code_robchar_tpu.models.base import (BatchResult, ControlOptimizer,
                                           cached_program)
from code_robchar_tpu.ops.realform import fidelity_from_controller_sym

_N_JIT = 2       # class-3 jitter candidates per round
_N_EXP = 7       # class-4/5 exploration candidates per round
_Q = 1 + _N_JIT + _N_EXP
_SHRINK = 0.96   # trust-radius shrink on a failed round
_GROW = 1.03     # growth on success
_R0 = 0.28       # initial trust radius (fraction of the box span)


def _snob_restarts_batched(x0s, key, infid_b, lower, upper, budget):
    """ALL restarts advance in lockstep; every round's K*Q candidates are
    ONE lanes objective batch (objectives.make_infidelity_batch)."""
    k, d = x0s.shape
    rounds = budget // _Q
    span = upper - lower

    key, k0 = jax.random.split(key)
    f0, c0 = infid_b(x0s, k0)
    mem_x0 = jnp.zeros((k, _Q, d), x0s.dtype) + x0s[:, None, :]
    mem_f0 = jnp.zeros((k, _Q), f0.dtype) + f0[:, None]

    def round_body(r, carry):
        best_x, best_f, radius, nfev, key, mem_x, mem_f = carry
        key, kg, ku, kc = jax.random.split(key, 4)

        # class-1/2 model point: linear least-squares gradient of the
        # previous round's SCATTERED evaluations (SNOBFIT neighbor-fit
        # analogue — deliberately noisy, no clean finite differences)
        dx = mem_x - best_x[:, None, :]
        df = mem_f - best_f[:, None]
        # least squares via batched normal equations (a vmapped SVD lstsq
        # dominates the round on the device); tiny Tikhonov term for rank
        # safety.  HIGHEST: the normal equations square the design
        # matrix's condition number, which a TF32 product would not survive.
        hi = jax.lax.Precision.HIGHEST
        ata = jnp.einsum("kqa,kqb->kab", dx, dx, precision=hi)
        ata = ata + 1e-9 * jnp.eye(d, dtype=dx.dtype)[None]
        atb = jnp.einsum("kqa,kq->ka", dx, df, precision=hi)
        g = jnp.linalg.solve(ata, atb[..., None])[..., 0]
        gn = jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-12
        model_pt = best_x - radius * g / gn

        jit = best_x[:, None, :] + radius[:, None, :] * \
            jax.random.normal(kg, (k, _N_JIT, d), x0s.dtype)
        exp = lower + span * jax.random.uniform(ku, (k, _N_EXP, d),
                                                x0s.dtype)
        cands = jnp.clip(jnp.concatenate(
            [model_pt[:, None, :], jit, exp], axis=1), lower, upper)
        fs, cs = infid_b(cands.reshape(k * _Q, d), kc)
        fs = fs.reshape(k, _Q)
        nfev = (nfev + jnp.sum(cs.reshape(k, _Q), axis=1)).astype(jnp.int32)

        i = jnp.argmin(fs, axis=1)
        fi = jnp.take_along_axis(fs, i[:, None], axis=1)[:, 0]
        xi = jnp.take_along_axis(cands, i[:, None, None], axis=1)[:, 0]
        improved = fi < best_f
        best_x = jnp.where(improved[:, None], xi, best_x)
        best_f = jnp.where(improved, fi, best_f)
        radius = jnp.where(improved[:, None],
                           jnp.minimum(radius * _GROW, span),
                           jnp.maximum(radius * _SHRINK, 1e-6 * span))
        return best_x, best_f, radius, nfev, key, cands, fs

    init = (x0s, f0, jnp.broadcast_to(_R0 * span, x0s.shape),
            c0.astype(jnp.int32), key, mem_x0, mem_f0)
    out = jax.lax.fori_loop(0, rounds, round_body, init)
    return out[0], out[1], out[3]


class SNOB(ControlOptimizer):
    name = "snob"
    budget_per_restart = 300

    def __init__(self, *args, budget: int = 300, **kwargs):
        super().__init__(*args, **kwargs)
        self.budget = budget  # qnewton.py:818-821: 300 either way

    def _build_batch_fn(self):
        use_fixed = self.use_fixed_ham
        mul_fac = self.train_size if use_fixed else 1
        lower, upper = self._lower, self._upper
        budget = self.budget
        h0, in_spin, out_spin = jnp.real(self.HH), self.In, self.Out
        make_spec = self._traced_spec_fn()
        # reference accounting: funccalls += budget (*train_size when
        # fixed-ham), regardless of the solver's internal eval count
        # (qnewton.py:862-866); adaptive uses the in-band increments.
        flat_bill = None if self.adaptive else budget * mul_fac

        def run_batch_impl(x0s, keys, noise, fixed):
            # spec built inside the trace: the noise level / fixed
            # ensemble are operands (base._PROGRAM_CACHE)
            spec = make_spec(noise, fixed)
            infid_b = objectives.make_infidelity_batch(spec)
            k = x0s.shape[0]
            xs, f, nfev = _snob_restarts_batched(x0s, keys[0], infid_b,
                                                 lower, upper, budget)
            if use_fixed:
                fids = trues = 1.0 - f  # qnewton.py:842-844
            else:
                # rank by SNOBFIT's reported optimum 1 - optval = the min
                # over the noisy history (qnewton.py:836-838) — NOT a
                # fresh draw; true_fid is the clean recompute
                # (qnewton.py:845-848)
                fids = 1.0 - f
                trues = jax.vmap(
                    lambda x: fidelity_from_controller_sym(
                        h0, x, in_spin, out_spin))(xs)
            billed = (nfev if flat_bill is None
                      else jnp.full((k,), flat_bill, jnp.int32))
            return BatchResult(xs, fids, trues, billed,
                               jnp.zeros(k, jnp.int32))

        if use_fixed:
            return jax.jit(run_batch_impl)
        return jax.jit(lambda x0s, keys, noise:
                       run_batch_impl(x0s, keys, noise, None))

    def _program_key(self) -> tuple:
        return ("snob", self._objective_statics(), self.budget)

    def _run_batch(self, x0s, keys) -> BatchResult:
        fn = cached_program(self._program_key(), self._build_batch_fn)
        if self.use_fixed_ham:
            return fn(x0s, keys, self._noise_operand(), self.randH)
        return fn(x0s, keys, self._noise_operand())
