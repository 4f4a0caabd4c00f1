"""Optimizer-zoo behavior tests.

Strategy per SURVEY.md §7.4: sequential optimizers are validated on
*fcall-budget-matched outcome quality* and exact record/accounting
semantics, not per-iteration trajectories.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from code_robchar_tpu.models import LBFGS, Adam, NMPlus, SNOB, MODEL_REGISTRY
from code_robchar_tpu.models.env import Environment


RECORD_KEYS = {"time_to_get_fid", "func_calls", "iterations", "repeats",
               "best_fid", "controller"}


def test_registry_matches_reference():
    assert set(MODEL_REGISTRY) == {"ppo", "lbfgs", "snob", "adam", "nmplus"}


def test_lbfgs_noiseless_threshold_mode():
    opt = LBFGS(4, 0, 2, repeats=256, fid_threshold=0.98, max_time=30,
                testing=True, restart_batch=64)
    fid = opt.run()
    assert fid is not None and fid > 0.98
    assert RECORD_KEYS <= set(opt.record)
    assert opt.record["func_calls"] > 0
    assert len(opt.record["controller"]) == 5
    # controller respects bounds
    c = np.asarray(opt.record["controller"])
    assert np.all(c[:4] >= -10 - 1e-9) and np.all(c[:4] <= 10 + 1e-9)
    assert 0 <= c[4] <= 30


def test_lbfgs_gradient_quality_vs_scipy_budget():
    """Outcome parity, best-of: the frozen scipy fmin_l_bfgs_b artifact
    (artifacts/scipy_lbfgs_dist.json) reaches 0.99917 over 512 restarts
    on N=4 0->2; the batched kernel must reach the same optimum region."""
    opt = LBFGS(4, 0, 2, repeats=128, fid_threshold=0.995, testing=True,
                restart_batch=128)
    fid = opt.run()
    assert fid > 0.995


def test_lbfgs_outcome_distribution_matches_scipy():
    """The sanctioned parity contract (SURVEY §7.4): budget-matched
    restart-outcome DISTRIBUTIONS.  Compare a 512-restart noiseless batch
    against the frozen scipy fmin_l_bfgs_b distribution generated by
    artifacts/scipy_lbfgs_baseline.py (VERDICT r2 weak #4 — replaces the
    old hardcoded-constant comment).  Measured KS ~ 0.07 (p > 0.15) on
    both committed transitions; gate at 0.12."""
    import json
    import scipy.stats

    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "scipy_lbfgs_dist.json")
    art = json.load(open(path))
    for n, out in ((4, 2), (5, 2)):
        ref = np.asarray(art[f"{n}_{out}"]["fids"])
        opt = LBFGS(n, 0, out, testing=True, seed=7)
        x0s = jnp.asarray(opt.init_points(512))
        keys = jax.random.split(jax.random.key(0), 512)
        res = opt._run_batch(x0s, keys)
        stat, p = scipy.stats.ks_2samp(np.asarray(res.fid), ref)
        assert stat < 0.12, (f"N={n} 0->{out}: KS {stat:.3f} (p={p:.3f}) "
                             f"vs frozen scipy distribution")


def test_nmplus_outcome_distribution_matches_scipy():
    """SURVEY §7.4 outcome-distribution parity gate for the NM family
    (VERDICT r4 next #1a): budget-matched (maxfev=300/restart,
    nmplus.py:212-228) restart-outcome distributions, 512 restarts,
    KS-compared against the frozen scipy Nelder-Mead distribution
    generated by artifacts/scipy_nm_baseline.py (pure numpy/scipy
    objective — independent of this repo's kernels).  Measured KS 0.055
    (p=0.43) on both committed transitions with mean nfev 289.6 vs
    288.8 (N=4) and 299.8 vs 299.2 (N=5); gate at 0.12 like the LBFGS
    gate above."""
    import json
    import scipy.stats

    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "scipy_nm_dist.json")
    art = json.load(open(path))
    for n, out in ((4, 2), (5, 2)):
        ref = np.asarray(art[f"{n}_{out}"]["fids"])
        opt = NMPlus(n, 0, out, testing=True, seed=7)
        x0s = jnp.asarray(opt.init_points(512))
        keys = jax.random.split(jax.random.key(0), 512)
        res = opt._run_batch(x0s, keys)
        stat, p = scipy.stats.ks_2samp(np.asarray(res.fid), ref)
        assert stat < 0.12, (f"N={n} 0->{out}: KS {stat:.3f} (p={p:.3f}) "
                             f"vs frozen scipy NM distribution")
        # the per-restart budget currency must match too: reference NM
        # bills x.nfev (a pure eval count), ~289/299 of the 300 budget
        assert abs(float(np.mean(np.asarray(res.nfev))) -
                   art[f"{n}_{out}"]["mean_nfev"]) < 15


def test_lbfgs_landscape_exploration_collects_topc():
    opt = LBFGS(4, 0, 2, repeats=10**9, fid_threshold=0.0, testing=True,
                run_until_told_to_stop=True, run_until_completion_its=20000,
                landscape_exploration=True, save_topc=50,
                records_update_rate=5000, restart_batch=32)
    opt.run()
    assert "controllers" in opt.record
    assert 1 <= len(opt.record["controllers"]) <= 50
    assert opt.record["func_calls"] + 1 >= 20000
    assert len(opt.records) >= 1  # fcall checkpoints captured


def test_lbfgs_ham_noisy_runs():
    opt = LBFGS(4, 0, 2, repeats=64, fid_threshold=0.8, testing=True,
                ham_noisy=True, noise=0.02, restart_batch=32)
    fid = opt.run()
    assert fid is None or 0 <= fid <= 1.0 + 1e-9
    if fid is not None:
        # noisy path: best_fid records the TRUE fidelity (qnewton.py:582-585)
        assert 0 <= opt.record["best_fid"] <= 1 + 1e-9


def test_lbfgs_use_wass_cost_changes_objective():
    """The flag must actually change what is trained (VERDICT r2 missing
    #3).  Trajectory-level divergence is not observable at reference
    settings — fd gradients (eps=1e-8) on a redrawn-noise objective are
    noise-dominated, so the noisy optimizer stays near its Sobol inits
    under EITHER objective, exactly like scipy approx_grad — so assert
    the objective substitution itself: over a set of good controllers,
    the Wasserstein robustness cost orders them differently than
    infidelity (robust != fidelity-optimal), i.e. training on it targets
    a different optimum."""
    from code_robchar_tpu.models import objectives

    opt = LBFGS(4, 0, 2, repeats=64, fid_threshold=2.0, testing=True,
                ham_noisy=True, noise=0.1, restart_batch=64,
                run_until_told_to_stop=True, run_until_completion_its=10**8,
                landscape_exploration=True, save_topc=64)
    xs = jnp.asarray(opt.init_points(64))
    # clean infidelity of each candidate vs its wass robustness cost
    spec = opt.spec()
    wass_b = objectives.make_wass_cost_batch(spec, 200)
    wass, bills = wass_b(xs, jax.random.key(3))
    from code_robchar_tpu.ops.realform import fidelity_from_controller_sym
    clean = 1.0 - jax.vmap(
        lambda x: fidelity_from_controller_sym(opt.HH, x, 0, 2))(xs)
    wass = np.asarray(wass)
    clean = np.asarray(clean)
    assert np.all(np.asarray(bills) == 200)
    assert np.all((wass >= 0) & (wass <= 1))
    # the two objectives induce different orderings (and different optima
    # somewhere in the candidate set) -> the flag changes what is trained
    assert not np.array_equal(np.argsort(wass), np.argsort(clean))


def test_lbfgs_wass_billing_is_reps_per_eval():
    """Each wass-cost objective call probes 5 ham-noisy fidelities and
    bills exactly 5 fcalls (no double-billing quirk on this path — the
    reference branch never ran, so there is no quirk to mirror)."""
    opt = LBFGS(4, 0, 2, testing=True, ham_noisy=True, noise=0.1,
                use_wass_cost=True, restart_batch=8)
    res = opt._run_batch(jnp.asarray(opt.init_points(8)),
                         jax.random.split(jax.random.key(0), 8))
    nfev = np.asarray(res.nfev)
    assert np.all(nfev > 0) and np.all(nfev % 5 == 0)


def test_lbfgs_maxfun_gate_counts_objective_calls_not_billing():
    """scipy's maxfun counts OBJECTIVE calls; adaptive shot billing
    (extra + draws per call) goes to a separate counter in the reference
    (qnewton.py:421).  The lane-freeze gate must therefore be invariant
    to per-call billing: the same deterministic objective billed at 1x
    and at 50x per evaluation must produce IDENTICAL trajectories and
    iteration counts, with only nfev scaled.  (Before the round-3 fix
    the gate compared billed fcalls against maxfun, stopping heavily-
    billed restarts ~billing-times early.)"""
    from code_robchar_tpu.models.lbfgs import _batched_restarts

    rng = np.random.default_rng(7)
    x0s = jnp.asarray(rng.uniform(-2, 2, (16, 5)))
    lower = jnp.full(5, -5.0)
    upper = jnp.full(5, 5.0)

    def rosen(xs):
        return jnp.sum(100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2 +
                       (1.0 - xs[:, :-1]) ** 2, axis=1)

    def make_vag(cost):
        def vag(xs, key):
            fv = rosen(xs)
            gv = jax.vmap(jax.grad(lambda x: rosen(x[None])[0]))(xs)
            return fv, gv, jnp.full(xs.shape[0], cost, jnp.int32)
        return vag

    key = jax.random.key(0)
    # maxfun=25 binds: 5-d Rosenbrock needs far more evals to converge
    r1 = _batched_restarts(x0s, key, make_vag(1), lower, upper,
                           maxiter=200, maxfun=25, lanes=8,
                           calls_per_eval=1)
    r50 = _batched_restarts(x0s, key, make_vag(50), lower, upper,
                            maxiter=200, maxfun=25, lanes=8,
                            calls_per_eval=1)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r50.x))
    np.testing.assert_array_equal(np.asarray(r1.nit), np.asarray(r50.nit))
    np.testing.assert_array_equal(np.asarray(r1.nfev) * 50,
                                  np.asarray(r50.nfev))
    assert np.asarray(r1.nit).max() > 3   # the gate, not instant freeze


def test_nm_maxfev_gate_counts_objective_calls_not_billing():
    """Same contract as the LBFGS gate test: scipy NM's maxfev counts
    objective evaluations, so the batched NM termination gate must be
    invariant to per-eval billing — identical best points and iteration
    counts at 1x and 50x billing.  Unlike LBFGS/SNOB/PPO the reference's
    NM never consumes adp_func_calls_increment (NMPlus.run bills x.nfev
    only, nmplus.py:251-256), so nfev is ALSO billing-invariant: a pure
    evaluation count in every regime."""
    from code_robchar_tpu.models.nmplus import (_nm_while_batched,
                                                regular_simplex)

    rng = np.random.default_rng(11)
    d = 4
    lower = jnp.full(d, -5.0)
    upper = jnp.full(d, 5.0)
    x0s = jnp.asarray(rng.uniform(-2, 2, (12, d)))
    keys = jax.random.split(jax.random.key(3), 12)
    simplex0 = jax.vmap(
        lambda x, k: regular_simplex(x, lower, upper, k))(x0s, keys)

    def make_infid_b(cost):
        def infid_b(xs, key):
            fv = jnp.sum(100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2 +
                         (1.0 - xs[:, :-1]) ** 2, axis=1)
            return fv, jnp.full(xs.shape[0], cost, jnp.int32)
        return infid_b

    key = jax.random.key(0)
    # maxfev=60 binds: 4-d Rosenbrock needs hundreds of evals to converge
    x1, f1, n1, it1 = _nm_while_batched(simplex0, key, make_infid_b(1),
                                        lower, upper, maxfev=60, lanes=6)
    x50, f50, n50, it50 = _nm_while_batched(simplex0, key, make_infid_b(50),
                                            lower, upper, maxfev=60, lanes=6)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x50))
    np.testing.assert_array_equal(np.asarray(it1), np.asarray(it50))
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n50))
    assert np.asarray(it1).max() > 3


def test_lbfgs_wass_requires_noisy_run():
    opt = LBFGS(4, 0, 2, testing=True, use_wass_cost=True)
    with pytest.raises(NotImplementedError):
        opt._build_batch_fn()


def test_lbfgs_wass_rejects_fixed_ham():
    """use_fixed_ham + use_wass_cost is undefined (the wass cost never
    consults the ensemble) — must fail loudly, not train 1-RIM as if it
    were a fidelity."""
    opt = LBFGS(4, 0, 2, testing=True, ham_noisy=True, use_fixed_ham=True,
                use_wass_cost=True)
    with pytest.raises(NotImplementedError):
        opt._build_batch_fn()


def test_wass_cost_rejected_outside_lbfgs():
    for cls in (Adam, NMPlus, SNOB):
        with pytest.raises(NotImplementedError):
            cls(4, 0, 2, testing=True, use_wass_cost=True,
                run_until_told_to_stop=True, landscape_exploration=True)


def test_budget_overshoot_bounded():
    """run() shrinks the final restart batch from the remaining fcall
    budget (VERDICT r2 weak #3, mirroring qnewton.py:595-625's
    per-restart check): flat-billed SNOB overshoots by < one restart's
    evals; variable-billed NM/LBFGS by < a few restarts' average."""
    budget = 100_000
    kw = dict(fid_threshold=0.0, repeats=10**9, testing=True,
              run_until_told_to_stop=True, run_until_completion_its=budget,
              landscape_exploration=True, save_topc=16, restart_batch=128)
    snob = SNOB(4, 0, 2, **kw)
    snob.run()
    assert 0 <= snob.record["func_calls"] - budget < 300

    for cls in (NMPlus, LBFGS):
        opt = cls(4, 0, 2, **kw)
        opt.run()
        fc = opt.record["func_calls"]
        per = fc / opt.record["repeats"]
        assert fc - budget < 3 * per, (cls.name, fc, per)


def test_budget_mode_dispatch_shape_is_constant():
    """Budget-mode runs must dispatch every restart batch at ONE
    deterministic shape (pad-and-slice): a data-dependent final-batch
    size pays a fresh XLA compile for one short
    dispatch.  The budget shrink instead slices results/billing, so the
    overshoot bound (test above) holds at a constant dispatch shape."""
    budget = 100_000
    kw = dict(fid_threshold=0.0, repeats=10**9, testing=True,
              run_until_told_to_stop=True, run_until_completion_its=budget,
              landscape_exploration=True, save_topc=16, restart_batch=128)
    opt = NMPlus(4, 0, 2, **kw)
    shapes = []
    orig = opt._run_batch
    opt._run_batch = lambda x0s, keys: (shapes.append(x0s.shape[0]),
                                        orig(x0s, keys))[1]
    opt.run()
    assert len(set(shapes)) == 1, shapes
    assert len(shapes) >= 2, "budget must span several batches"
    assert 0 <= opt.record["func_calls"] - budget < 3 * (
        opt.record["func_calls"] / opt.record["repeats"])


def test_adam_requires_le_mode():
    with pytest.raises(Exception):
        Adam(4, 0, 2, testing=True)


def test_adam_improves_under_budget():
    opt = Adam(4, 0, 2, repeats=10**9, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=4000,
               landscape_exploration=True, save_topc=20, restart_batch=16)
    opt.segment_its = 100
    best = opt.run()
    assert best is not None and best > 0.5  # Adam on exact grad moves
    assert opt.record["func_calls"] + 1 >= 4000


def test_nmplus_threshold_mode():
    opt = NMPlus(4, 0, 2, repeats=512, fid_threshold=0.95, testing=True,
                 restart_batch=128)
    fid = opt.run()
    assert fid is not None and fid > 0.95
    # nfev per restart bounded by the 300-eval budget contract
    assert opt.record["func_calls"] <= 512 * 320


def test_snob_budget_accounting():
    opt = SNOB(4, 0, 2, repeats=32, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=9600,
               landscape_exploration=True, save_topc=10, restart_batch=16)
    best = opt.run()
    # flat billing: every restart bills exactly budget=300
    assert opt.record["func_calls"] % 300 == 0
    assert best is not None


def test_fixed_ham_multiplier_accounting():
    opt = SNOB(4, 0, 2, repeats=8, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=10**7,
               landscape_exploration=True, save_topc=4,
               use_fixed_ham=True, opt_train_size=10, ham_noisy=True,
               restart_batch=4)
    opt.run()
    # budget * train_size per restart (qnewton.py:862-866)
    assert opt.record["func_calls"] % (300 * 10) == 0


def test_environment_wrapper_golden():
    env = Environment(3, 0, 2, np.zeros(3))
    env.reset()
    env.timestep = 22.035034
    _, fid, _ = env.step(np.diag([-0.20574245, 4.3713235, -0.30473375]))
    assert abs(fid - 0.90) < 5e-3


def test_environment_action_wrap():
    env = Environment(3, 0, 2, np.zeros(3), bmax=20)
    env.reset()
    env.timestep = 1.0
    env.step(np.diag([25.0, 0.1, 0.1]))  # |25| > bmax -> wraps by modulus
    assert np.all(np.abs(env.action) <= 20.0)


def test_environment_perturbation_hermitian():
    env = Environment(6, 0, 3, np.zeros(6))
    z = env.structured_perturabation(env.noise) + np.asarray(env.sys)
    assert np.allclose(z, z.conj().T)
    z2 = env.structured_perturabation(env.noise) + np.asarray(env.sys)
    assert not np.all(z == z2)


def test_adam_restart_retry_and_per_stream_candidates():
    """VERDICT r1 #4: (a) restart candidates are per-stream (no two
    streams may share a restart point), (b) the restart is retry-until-
    pass with per-probe billing (qnewton.py:681-700), (c) dense top-c
    offers fill the .le store beyond one-per-segment."""
    import jax
    import jax.numpy as jnp

    opt = Adam(4, 0, 2, repeats=10**9, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=1000,
               landscape_exploration=True, save_topc=64, restart_batch=8)
    from code_robchar_tpu.models.adam import _TABLE_LEN_MIN
    fns = opt._build_segments(8)
    table = jnp.asarray(opt._sobol_stream(_TABLE_LEN_MIN * 8)).reshape(
        _TABLE_LEN_MIN, 8, 5)
    w0 = jnp.asarray(opt.init_points(8))
    m0 = jnp.zeros((8, 5))
    v0 = jnp.zeros((8, 5))
    it0 = jnp.zeros(8, jnp.int32)
    ptr0 = jnp.zeros(8, jnp.int32)
    keys = jax.random.split(jax.random.key(0), 8)

    # restart variant: every stream restarts once, probes billed; the
    # Sobol table and noise level are runtime operands (base._PROGRAM_CACHE)
    out = fns[1](w0, m0, v0, it0, ptr0, keys, table, opt._noise_operand())
    (w, m, v, it, ptr, fid, true, calls, nit, cand_fid, cand_x) = out
    assert int(it[0]) == opt.segment_its
    # each stream consumed >= 1 probe: ptr advanced, calls > seg
    assert (np.asarray(ptr) >= 1).all()
    assert (np.asarray(calls) == opt.segment_its + np.asarray(ptr)).all()
    # candidate stack shape + top-1 candidate >= final fid
    assert cand_x.shape == (8, opt.cand_per_segment, 5)
    assert (np.asarray(cand_fid)[:, 0] >= np.asarray(fid) - 1e-12).all()

    # per-stream restart points: probe the Sobol table directly — entry
    # [ptr, sid] is global draw ptr*K + sid, so rows across sids differ
    tbl = jnp.asarray(opt._sobol_stream(4)).reshape(-1)  # just advance
    # run a full budget and check the .le store densifies
    opt2 = Adam(4, 0, 2, repeats=10**9, fid_threshold=0.0, testing=True,
                run_until_told_to_stop=True,
                run_until_completion_its=6000,
                landscape_exploration=True, save_topc=64, restart_batch=8)
    opt2.run()
    ctrls = opt2.record["controllers"]
    # one segment fits the budget: 8 finals alone would store <= 8; the
    # in-scan candidates must densify well beyond that (fid-key
    # collisions may drop a few, qnewton.py:604-616 dict semantics)
    assert len(ctrls) >= 24
    # no two stored controllers identical (restart-collapse symptom)
    arr = np.asarray(ctrls)
    assert np.unique(arr.round(12), axis=0).shape[0] == arr.shape[0]


def test_nm_stagnation_restart_fires():
    """In-house NM restarts the simplex after 30 stagnant iterations
    (nmplus.py:162-170); the restart must bill d+1 re-evaluations and
    the counter must only reset on restart."""
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.models.nmplus import _nm_while

    d = 3
    lower = jnp.full(d, -1.0)
    upper = jnp.full(d, 1.0)

    # constant objective: every iteration is stagnant, NM never converges
    # by spread (fvals all equal -> spread 0 stops the loop), so use a
    # flat-but-nonconverging objective: f depends only on x[0] sign noise
    def infid(x, key):
        return jnp.asarray(1.0) + 1e-3 * jnp.sum(x * x), jnp.int32(1)

    simplex0 = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (d + 1, d)))
    x, f, nfev_plain, nit_plain = _nm_while(
        simplex0, jax.random.key(0), infid, lower, upper, maxfev=400,
        fatol=0.0, xatol=0.0, stagnation_restart=False)
    x2, f2, nfev_rst, nit_rst = _nm_while(
        simplex0, jax.random.key(0), infid, lower, upper, maxfev=400,
        fatol=0.0, xatol=0.0, stagnation_restart=True,
        improv_thres=1e30)  # every iteration counts as stagnant
    # restarts fired -> trajectory diverges from the plain run
    assert not np.allclose(np.asarray(x), np.asarray(x2))
    # control: an impossible threshold (improv < 0 never holds for NM's
    # monotone best) must never restart -> bit-identical to plain
    x3, f3, nfev3, nit3 = _nm_while(
        simplex0, jax.random.key(0), infid, lower, upper, maxfev=400,
        fatol=0.0, xatol=0.0, stagnation_restart=True, improv_thres=0.0)
    np.testing.assert_array_equal(np.asarray(x3), np.asarray(x))
    assert int(nfev3) == int(nfev_plain) and int(nit3) == int(nit_plain)


def test_adam_restart_table_is_per_stream():
    """Regression: each stream must read ITS OWN Sobol table column at ITS
    OWN pointer — distinct pointers => distinct candidates."""
    import jax
    import jax.numpy as jnp

    opt = Adam(4, 0, 2, repeats=10**9, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=1000,
               landscape_exploration=True, save_topc=8, restart_batch=4)
    from code_robchar_tpu.models.adam import _TABLE_LEN_MIN
    fns = opt._build_segments(4)
    table = jnp.asarray(opt._sobol_stream(_TABLE_LEN_MIN * 4)).reshape(
        _TABLE_LEN_MIN, 4, 5)
    w0 = jnp.asarray(opt.init_points(4))
    z = jnp.zeros((4, 5))
    it0 = jnp.zeros(4, jnp.int32)
    # DIFFERENT starting pointers per stream
    ptr0 = jnp.asarray([0, 3, 7, 11], jnp.int32)
    keys = jax.random.split(jax.random.key(0), 4)
    out = fns[1](w0, z, z, it0, ptr0, keys, table, opt._noise_operand())
    w, m, v, it, ptr, fid, true, calls, nit, cf, cx = out
    # pointers advanced from their own bases
    assert (np.asarray(ptr) > np.asarray(ptr0)).all()
    # the post-restart trajectories must all differ (distinct candidates)
    arr = np.asarray(w).round(10)
    assert np.unique(arr, axis=0).shape[0] == 4


def test_adam_restart_table_never_wraps(monkeypatch):
    """VERDICT r3 weak #3: a long-budget, few-stream run must never reuse
    a restart point.  Force a tiny 8-row window with a restart every
    segment and drive the streams several window-lengths past it; at
    every segment boundary the rolling window [base, base+L) must hold
    exactly the global Sobol rows base..base+L-1 of the instance's
    stream (checked against an independent replayed SobolStream), and
    the pointers must end far beyond the original window length."""
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.models import adam as adam_mod
    from code_robchar_tpu.ops.sobol import SobolStream

    k, seg = 4, 8
    monkeypatch.setattr(adam_mod, "_RESTART_EVERY", seg)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MIN", 8)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MAX", 8)
    # keep the retry headroom small so the 8-row window ROLLS instead of
    # immediately growing to cover the 64-probe worst case
    monkeypatch.setattr(adam_mod, "_MAX_RETRIES", 4)
    opt = Adam(4, 0, 2, repeats=10**9, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True,
               run_until_completion_its=10**9,
               landscape_exploration=True, save_topc=8, restart_batch=k,
               segment_its=seg)
    x0 = jnp.asarray(opt.init_points(k))

    # independent replay of the instance's Sobol stream: init_points
    # consumed the first k draws; global restart row g is then draws
    # g*k..(g+1)*k-1 of what follows
    oracle = SobolStream(5)
    oracle.next(k)
    oracle_rows = np.empty((0, k, 5))

    def check_window():
        nonlocal oracle_rows
        tbl = np.asarray(opt._table)
        L, base = tbl.shape[0], opt._table_base
        while oracle_rows.shape[0] < base + L:
            oracle_rows = np.concatenate(
                [oracle_rows, oracle.next(k)[None]], axis=0)
        for g in range(base, base + L):
            np.testing.assert_array_equal(tbl[g % L], oracle_rows[g])

    for _ in range(40):  # 40 restart segments >> 8-row window
        keys = jax.random.split(opt.next_key(), k)
        opt._run_batch(x0, keys)
        x0 = opt._stream[0]
        check_window()

    ptr = np.asarray(opt._stream[4])
    assert ptr.max() >= 3 * 8          # well past the original window
    assert opt._table_base > 0         # the refill actually fired
    # strictly increasing per-stream pointers + the window invariant
    # above == no global Sobol row is ever read twice
    """Lane recycling (models/lbfgs.py round-3 layout): a narrow recycled
    hardware batch must reproduce every restart of the full-width batch —
    same iterates, same fids, identical fcall billing (the noiseless
    objective is key-independent, so trajectories are schedule-invariant
    up to lane-composition ulp drift)."""
    import jax
    import jax.numpy as jnp

    opt = LBFGS(4, 0, 2, testing=True, seed=13)
    x0s = jnp.asarray(opt.init_points(96))
    keys = jax.random.split(jax.random.key(3), 96)
    res_full = opt._run_batch(x0s, keys)                 # lanes = 96
    opt_rec = LBFGS(4, 0, 2, testing=True, seed=13, lane_width=32)
    res_rec = opt_rec._run_batch(x0s, keys)              # 32 lanes, recycled

    np.testing.assert_allclose(np.asarray(res_rec.fid),
                               np.asarray(res_full.fid), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_rec.x),
                               np.asarray(res_full.x), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(res_rec.nfev),
                                  np.asarray(res_full.nfev))
    np.testing.assert_array_equal(np.asarray(res_rec.nit),
                                  np.asarray(res_full.nit))


def test_nmplus_lane_recycling_preserves_restarts():
    """NM lane recycling (models/nmplus.py round-3 layout): same contract
    as the LBFGS test above — a 32-lane recycled batch must reproduce the
    full-width batch restart-for-restart."""
    import jax
    import jax.numpy as jnp

    opt = NMPlus(4, 0, 2, testing=True, seed=5)
    x0s = jnp.asarray(opt.init_points(96))
    keys = jax.random.split(jax.random.key(1), 96)
    res_full = opt._run_batch(x0s, keys)
    opt_rec = NMPlus(4, 0, 2, testing=True, seed=5, lane_width=32)
    res_rec = opt_rec._run_batch(x0s, keys)

    np.testing.assert_allclose(np.asarray(res_rec.fid),
                               np.asarray(res_full.fid), atol=1e-8)
    np.testing.assert_allclose(np.asarray(res_rec.x),
                               np.asarray(res_full.x), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(res_rec.nfev),
                                  np.asarray(res_full.nfev))
    np.testing.assert_array_equal(np.asarray(res_rec.nit),
                                  np.asarray(res_full.nit))


def test_program_cache_shares_compiles_across_sigma_cells():
    """The Experiment driver builds a FRESH model per (family, noise) cell
    (noise_analysis.py:337-344); the compiled batch programs must be
    shared across instances with the noise level as a runtime operand
    (base._PROGRAM_CACHE) — one XLA compile per family, not per cell —
    and the operand must be numerically equivalent to constructing the
    model at that sigma."""
    from code_robchar_tpu.models import base as mbase

    kw = dict(testing=True, fid_threshold=2.0, repeats=10**9,
              run_until_told_to_stop=True, run_until_completion_its=10**12,
              landscape_exploration=True, save_topc=8)
    for cls in (LBFGS, NMPlus, SNOB):
        before = len(mbase._PROGRAM_CACHE)
        outs = []
        for sigma in (0.03, 0.07, 0.03):
            opt = cls(4, 0, 2, ham_noisy=True, noise=0.05, seed=1, **kw)
            opt.noise = sigma  # the Experiment driver's mutation path
            r = opt._run_batch(jnp.asarray(opt.init_points(16)),
                               jax.random.split(jax.random.key(2), 16))
            outs.append(np.asarray(r.fid))
        # <= 1 new entry: 0 when an earlier test in this module already
        # compiled this family's program (sharing across tests too);
        # per-sigma keys would add 2+
        assert len(mbase._PROGRAM_CACHE) - before <= 1, cls.name
        np.testing.assert_array_equal(outs[0], outs[2])   # sigma revisit
        assert not np.allclose(outs[0], outs[1])          # sigma applied
        # operand == baked-at-construction semantics
        opt2 = cls(4, 0, 2, ham_noisy=True, noise=0.07, seed=1, **kw)
        r2 = opt2._run_batch(jnp.asarray(opt2.init_points(16)),
                             jax.random.split(jax.random.key(2), 16))
        np.testing.assert_array_equal(np.asarray(r2.fid), outs[1])

    # Adam: persistent streams, same sharing contract
    before = len(mbase._PROGRAM_CACHE)
    for sigma in (0.05, 0.1):
        a = Adam(4, 0, 2, ham_noisy=True, noise=sigma, seed=1,
                 segment_its=50, **kw)
        r = a._run_batch(jnp.asarray(a.init_points(8)),
                         jax.random.split(jax.random.key(0), 8))
        assert np.asarray(r.fid).shape == (8,)
    assert len(mbase._PROGRAM_CACHE) - before <= 1


def test_ppo_epoch_program_shared_across_sigma_cells():
    """PPO's jitted epoch is cached across instances with sigma_train as
    an operand: two trainers at different env.noise share one program,
    and mutating env.noise (the Experiment path) changes the rollout."""
    from code_robchar_tpu.models import base as mbase
    from code_robchar_tpu.models.ppo import PPO_en

    def make(sigma):
        p = PPO_en(4, 0, 2, testing=True, ham_noisy=True, noise=sigma,
                   fid_threshold=2.0, run_until_told_to_stop=True,
                   run_until_completion_its=10**12,
                   landscape_exploration=True, save_topc=8, num_agents=4)
        fn = p._build_epoch(8, 0.2, 3e-3, 1e-3, 1000, 5, 5, 0.01)
        st = jax.vmap(p._init_agent)(jax.random.split(jax.random.key(0), 4))
        return p, fn, st

    before = len(mbase._PROGRAM_CACHE)
    p1, fn1, st1 = make(0.05)
    _, out1 = fn1(st1)
    p2, fn2, st2 = make(0.1)
    _, out2 = fn2(st2)
    assert len(mbase._PROGRAM_CACHE) - before <= 1
    r1 = np.asarray(out1.rewards)
    assert not np.allclose(r1, np.asarray(out2.rewards))
    # Experiment mutates env.noise post-construction: same program object,
    # operand read at call time
    p1.env.noise = 0.1
    _, out3 = fn1(st1)
    np.testing.assert_array_equal(np.asarray(out3.rewards),
                                  np.asarray(out2.rewards))


def test_snob_skquant_adapter_gated():
    """VERDICT r3 next #3 / r4 next #3: the exact-path adapter must
    (a) import cleanly without skquant, (b) raise a helpful ImportError
    for backend='skquant' when that stack is absent (this container —
    no egress, no wheel), and (c) run the reference control flow
    end-to-end with the reference's record protocol on whichever
    engine resolves — here the vendored published-algorithm SNOBFIT
    (models/snobfit_core.py), so the exact path EXECUTES in this
    container instead of only under monkeypatched fakes."""
    import importlib.util

    import pytest

    from code_robchar_tpu.models import SNOBSkquant  # import always safe

    have = (importlib.util.find_spec("skquant") is not None
            and importlib.util.find_spec("SQSnobFit") is not None)
    if not have:
        with pytest.raises(ImportError, match="skquant"):
            SNOBSkquant(4, 0, 2, testing=True, backend="skquant")

    opt = SNOBSkquant(4, 0, 2, testing=True, fid_threshold=0.0,
                      run_until_told_to_stop=True,
                      run_until_completion_its=900,
                      landscape_exploration=True, save_topc=8)
    assert opt.backend_name == ("skquant" if have else "vendored")
    best = opt.run()
    assert best is not None and 0 <= best <= 1 + 1e-9
    # reference fcall accounting: 300 per restart, budget-stop after
    # the restart that crosses the budget completes
    assert opt.record["func_calls"] >= 900
    assert opt.record["func_calls"] % 300 == 0
    assert 1 <= len(opt.record["controllers"]) <= 8
    assert len(opt.record["controllers"][0]) == 5


def test_adam_sobol_contiguous_through_run(monkeypatch):
    """The rolling-window contract must hold for runs driven through the
    PUBLIC run() loop, not just direct _run_batch calls: base.run
    consumes init_points exactly once for persistent streams, so the
    restart table stays a plain continuation of the instance Sobol
    stream (one k-draw init block, then table rows in order)."""
    import jax.numpy as jnp  # noqa: F401
    from code_robchar_tpu.models import adam as adam_mod
    from code_robchar_tpu.ops.sobol import SobolStream

    k, seg = 4, 8
    monkeypatch.setattr(adam_mod, "_RESTART_EVERY", seg)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MIN", 8)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MAX", 8)
    monkeypatch.setattr(adam_mod, "_MAX_RETRIES", 4)
    segments = 30
    opt = Adam(4, 0, 2, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True,
               run_until_completion_its=segments * k * seg,
               landscape_exploration=True, save_topc=8, restart_batch=k,
               segment_its=seg)
    opt.run()

    # replay: k init draws, then row g = draws g*k..(g+1)*k-1
    oracle = SobolStream(5)
    oracle.next(k)
    tbl = np.asarray(opt._table)
    L, base = tbl.shape[0], opt._table_base
    rows = np.stack([oracle.next(k) for _ in range(base + L)])
    for g in range(base, base + L):
        np.testing.assert_array_equal(tbl[g % L], rows[g])
    assert base > 0          # the refill fired through run()
    ptr = np.asarray(opt._stream[4])
    assert ptr.max() > 8     # streams restarted well past the window


def test_adam_refill_pointer_lift_cap(monkeypatch):
    """Extreme retry skew must not grow the window past _TABLE_LEN_MAX:
    the refill lifts laggard pointers instead (skipping draws is allowed
    — only re-reading a row is not) and the live rows still match the
    sequential Sobol replay."""
    import jax.numpy as jnp
    from code_robchar_tpu.models import adam as adam_mod
    from code_robchar_tpu.ops.sobol import SobolStream

    k, seg = 4, 8
    monkeypatch.setattr(adam_mod, "_RESTART_EVERY", seg)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MIN", 8)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MAX", 16)
    monkeypatch.setattr(adam_mod, "_MAX_RETRIES", 4)
    opt = Adam(4, 0, 2, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=10**9,
               landscape_exploration=True, save_topc=8, restart_batch=k,
               segment_its=seg)
    x0 = jnp.asarray(opt.init_points(k))
    keys = jax.random.split(opt.next_key(), k)
    opt._run_batch(x0, keys)     # initialise stream + 8-row window

    # hand a pointer spread far beyond the 16-row cap
    w, m, v, it, _ = opt._stream
    skewed = jnp.asarray([0, 1, 2, 100], jnp.int32)
    opt._stream = (w, m, v, it, skewed)
    opt._maybe_refill_table(k, None)

    tbl = np.asarray(opt._table)
    assert tbl.shape[0] == 16                    # capped, not 128
    ptr = np.asarray(opt._stream[4])
    base = opt._table_base
    hi_need = 100 + adam_mod._MAX_RETRIES
    assert base == hi_need - 16                  # window ends at hi_need
    assert (ptr >= base).all()                   # laggards lifted
    assert ptr[3] == 100                         # leader untouched
    # live rows are the true sequential draws for their labels
    oracle = SobolStream(5)
    oracle.next(k)                               # init block
    rows = np.stack([oracle.next(k) for _ in range(base + 16)])
    for g in range(base, base + 16):
        np.testing.assert_array_equal(tbl[g % 16], rows[g])


def test_adam_segment_uses_lifted_pointers(monkeypatch):
    """Integration of the pointer-lift with the segment dispatch: when a
    restart-due segment triggers the lift, the dispatched program must
    see the LIFTED pointers, not the pre-lift ones _run_batch unpacked
    earlier — otherwise laggard streams re-read rows the leader already
    consumed (the exact reuse the window forbids)."""
    import jax.numpy as jnp
    from code_robchar_tpu.models import adam as adam_mod

    k, seg = 4, 8
    monkeypatch.setattr(adam_mod, "_RESTART_EVERY", seg)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MIN", 8)
    monkeypatch.setattr(adam_mod, "_TABLE_LEN_MAX", 16)
    monkeypatch.setattr(adam_mod, "_MAX_RETRIES", 4)
    opt = Adam(4, 0, 2, fid_threshold=0.0, testing=True,
               run_until_told_to_stop=True, run_until_completion_its=10**9,
               landscape_exploration=True, save_topc=8, restart_batch=k,
               segment_its=seg)
    x0 = jnp.asarray(opt.init_points(k))
    keys = jax.random.split(opt.next_key(), k)
    opt._run_batch(x0, keys)     # initialise stream + window

    w, m, v, it, _ = opt._stream
    skewed = jnp.asarray([0, 1, 2, 100], jnp.int32)
    opt._stream = (w, m, v, it, skewed)
    # its_done is seg after the first segment, so the next one is
    # restart-due -> refill (lift) + restart segment in one dispatch
    opt._run_batch(x0, jax.random.split(opt.next_key(), k))

    base = opt._table_base
    ptr = np.asarray(opt._stream[4])
    assert base > 0                              # the lift fired
    # every stream advanced FROM a lifted pointer: all at/above base
    # (pre-fix the laggards dispatched at 0/1/2 and landed below base)
    assert (ptr >= base).all(), (ptr, base)
    # and within the live window
    assert (ptr < base + 16 + adam_mod._MAX_RETRIES).all()


def test_adam_segment_its_must_divide_restart_cadence():
    """A segment size that doesn't divide the reference's 5000-update
    restart cadence would silently skip (or never fire) the Sobol
    restarts (qnewton.py:681-700) — the constructor must refuse it."""
    import pytest

    with pytest.raises(ValueError, match="restart cadence"):
        Adam(4, 0, 2, fid_threshold=0.0, testing=True,
             run_until_told_to_stop=True, run_until_completion_its=1000,
             landscape_exploration=True, save_topc=8, segment_its=999)
    # dividing sizes construct fine
    Adam(4, 0, 2, fid_threshold=0.0, testing=True,
         run_until_told_to_stop=True, run_until_completion_its=1000,
         landscape_exploration=True, save_topc=8, segment_its=500)


def _stub_skquant(monkeypatch, calls):
    """Monkeypatch the adapter's loader with a fake skquant whose
    minimize returns a fixed mediocre optimum and counts invocations."""
    from code_robchar_tpu.models import snob_skquant as mod

    class _Res:
        optval = 0.9        # fi = 0.1: never passes a high threshold
        optpar = np.zeros(5)

    class _Skq:
        @staticmethod
        def minimize(f, x0, bounds=None, budget=None, method=None,
                     options=None):
            calls.append(budget)
            return _Res(), None

    monkeypatch.setattr(mod, "_load_backend",
                        lambda backend="auto": (_Skq(),
                                                lambda optin: optin,
                                                "stub"))


def test_snob_skquant_budget_stops_without_extra_restart(monkeypatch):
    """base.run returns as soon as billing crosses the budget; the
    adapter must too — the completion gate belongs to the SAME rep that
    exhausted the budget, not the next one (which would burn a whole
    extra 300-eval SNOBFIT restart)."""
    from code_robchar_tpu.models.snob_skquant import SNOBSkquant

    calls = []
    _stub_skquant(monkeypatch, calls)
    opt = SNOBSkquant(4, 0, 2, testing=True, fid_threshold=0.0,
                      run_until_told_to_stop=True,
                      run_until_completion_its=300,
                      landscape_exploration=True, save_topc=4)
    best = opt.run()
    assert len(calls) == 1, f"extra restart past the budget: {len(calls)}"
    assert best is not None
    assert opt.record["func_calls"] == 300


def test_snob_skquant_threshold_mode_honours_timeout(monkeypatch):
    """The wall-clock fail-safe must fire in threshold mode too (the
    reference raises AssertionError('timeout') in both stop modes)."""
    import pytest
    from code_robchar_tpu.models.snob_skquant import SNOBSkquant

    calls = []
    _stub_skquant(monkeypatch, calls)
    opt = SNOBSkquant(4, 0, 2, testing=True, fid_threshold=0.99,
                      run_until_told_to_stop=False, max_time=30)
    opt.timeout = -1.0       # already expired
    opt.repeats = 50
    with pytest.raises(AssertionError, match="timeout"):
        opt.run()
    assert len(calls) == 1   # detected on the first rep, not after 50
