"""Coverage-gap closure (VERDICT r4 next #6): targeted tests for the
non-plotting modules the merged covmon report put under ~90% —
objectives' single-point paths, datasim's pooling/t-SNE/merge tools,
the checkpoint helpers, the config cache bootstrap, stats' Gaussian VN
variant, and the skquant adapter's threshold/fixed-ham regimes."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from code_robchar_tpu.models import objectives
from code_robchar_tpu.ops import chain


def _spec(**over):
    kw = dict(h0=chain.xx_hamiltonian_real(4), in_spin=0, out_spin=2,
              noise=0.05, fid_noisy=False, ham_noisy=False, draws=100,
              adaptive=False, adp_tol=0.01, fixed_hams=None, mul_fac=1)
    kw.update(over)
    return objectives.ObjectiveSpec(**kw)


def test_make_infidelity_single_point_regimes():
    """The scalar objective across every noise regime (the batch lanes
    variant is covered by the zoo tests; this pins the single-point
    path the SNOBFIT/scipy-style drivers consume)."""
    x = jnp.asarray([1.0, -2.0, 0.5, 3.0, 12.0])
    key = jax.random.key(0)

    clean = objectives.make_infidelity(_spec())
    v0, c0 = clean(x, key)
    assert 0.0 <= float(v0) <= 1.0 and int(c0) == 1

    hamn = objectives.make_infidelity(_spec(ham_noisy=True))
    v1, c1 = hamn(x, key)
    assert abs(float(v1) - float(v0)) > 1e-9 and int(c1) == 1

    shot = objectives.make_infidelity(_spec(fid_noisy=True, draws=50))
    v2, c2 = shot(x, key)
    assert float(v2) * 50 == pytest.approx(round(float(v2) * 50))
    assert int(c2) == 1

    adp = objectives.make_infidelity(_spec(fid_noisy=True, adaptive=True,
                                           draws=20))
    v3, c3 = adp(x, key)
    assert 0.0 <= float(v3) <= 1.0
    assert int(c3) >= 20          # in-band billing includes extra draws

    hams = jnp.stack([chain.xx_hamiltonian_real(4)] * 3)
    fixed = objectives.make_infidelity(_spec(fixed_hams=hams, mul_fac=3))
    v4, c4 = fixed(x, key)
    np.testing.assert_allclose(float(v4), float(v0), atol=1e-10)
    assert int(c4) == 1           # raw count; multiplier is billing-side

    fixed_shot = objectives.make_infidelity(
        _spec(fixed_hams=hams, fid_noisy=True, draws=50, mul_fac=3))
    v5, _ = fixed_shot(x, key)
    assert 0.0 <= float(v5) <= 1.0


def test_exact_and_fd_gradients_agree():
    x = jnp.asarray([1.0, -2.0, 0.5, 3.0, 12.0])
    exact = objectives.make_exact_gradient(_spec())
    err, g = exact(x)
    infid = objectives.make_infidelity(_spec())
    fd = objectives.make_fd_gradient(infid, dim=5, eps=1e-6)
    err2, g2, bill = fd(x, jax.random.key(0))
    np.testing.assert_allclose(float(err2), float(err), atol=1e-8)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g), atol=1e-4)
    assert int(bill) == 6         # 1 center + 5 forward probes

    infid_b = objectives.make_infidelity_batch(_spec())
    fdb = objectives.make_fd_gradient_batch(infid_b, dim=5, eps=1e-6)
    errs, gs, bills = fdb(jnp.stack([x, x]), jax.random.key(0))
    np.testing.assert_allclose(np.asarray(gs)[0], np.asarray(g), atol=1e-4)
    assert np.asarray(bills).shape == (2,)


def test_infidelity_batch_fixed_ham_fid_noisy():
    """The batch fixed-ham + shot-noise branch (objectives.py:215-218)."""
    hams = jnp.stack([chain.xx_hamiltonian_real(4)] * 3)
    infid_b = objectives.make_infidelity_batch(
        _spec(fixed_hams=hams, fid_noisy=True, draws=50, mul_fac=3))
    xs = jnp.asarray([[1.0, -2.0, 0.5, 3.0, 12.0],
                      [0.5, 1.0, -1.0, 2.0, 8.0]])
    vals, bills = infid_b(xs, jax.random.key(1))
    assert vals.shape == (2,) and np.all(np.asarray(bills) == 1)
    assert np.all((np.asarray(vals) >= 0) & (np.asarray(vals) <= 1))


def test_vn_test_gaussian_variant_and_guards():
    from code_robchar_tpu.metrics.stats import vn_test

    rng = np.random.default_rng(0)
    rand = rng.normal(size=200)
    ok, phi = vn_test(rand, bartels=False, verbose=True)
    assert ok and phi > 0
    trend = np.linspace(0, 1, 200) + 1e-3 * rng.normal(size=200)
    bad, _ = vn_test(trend, bartels=False)
    assert not bad
    with pytest.raises(ValueError, match="insufficient"):
        vn_test(np.arange(10))


def test_checkpoint_roundtrip_and_pickle_fallback(tmp_path, monkeypatch):
    from code_robchar_tpu.utils import checkpoint as ckpt

    state = {"w": jnp.arange(6.0).reshape(2, 3), "step": jnp.asarray(7)}
    path = str(tmp_path / "ck" / "state")
    out = ckpt.save_state(path, state)
    rest = ckpt.restore_state(out if out.endswith(".pkl") else path,
                              template=state)
    np.testing.assert_array_equal(np.asarray(rest["w"]),
                                  np.asarray(state["w"]))

    # pickle fallback: break orbax at save time
    import orbax.checkpoint as ocp

    class Boom:
        def __init__(self):
            raise RuntimeError("no orbax")

    monkeypatch.setattr(ocp, "StandardCheckpointer", Boom)
    p2 = ckpt.save_state(str(tmp_path / "ck2" / "state"), state)
    assert p2.endswith(".pkl")
    rest2 = ckpt.restore_state(str(tmp_path / "ck2" / "state"))
    np.testing.assert_array_equal(np.asarray(rest2["step"]), 7)


def test_config_cache_bootstrap(tmp_path, monkeypatch):
    """config.py's persistent-cache setup: JAX_COMPILATION_CACHE_DIR is
    left to JAX (the package sets no directory of its own); restore the
    test harness' no-cache regime afterwards."""
    import importlib

    from code_robchar_tpu import config as cfg

    old = jax.config.jax_compilation_cache_dir
    target = str(tmp_path / "jaxcache")
    try:
        monkeypatch.delenv("ROBCHAR_NO_COMPILATION_CACHE", raising=False)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
        jax.config.update("jax_compilation_cache_dir", target)
        importlib.reload(cfg)
        assert cfg.compile_cache_dir() is None
        assert jax.config.jax_compilation_cache_dir == target
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _seed_store(tmp_path, nspin=4, n_ctrl=6):
    """Synthesize a two-algo .le store in the reference schema."""
    from code_robchar_tpu.exp.namer import ExperimentNamer

    rng = np.random.default_rng(0)
    gdir = str(tmp_path / "experiments")
    namer = ExperimentNamer(experiment_name="pipeline_cov", Nspin=nspin,
                            inspin=0, outspin=2, numcontrollers=n_ctrl,
                            global_dir=gdir)
    store = namer() + ".le"

    def ctrls(k):
        return np.column_stack([rng.uniform(-10, 10, (k, nspin)),
                                rng.uniform(1, 20, k)]).tolist()

    data = {
        "ppo": {"0.0": {"controller": ctrls(n_ctrl)},
                "0.05": {"controller": ctrls(n_ctrl)}},
        "lbfgs": {str(nspin): {"controller": ctrls(n_ctrl - 2)}},
    }
    json.dump(data, open(store, "w"))
    return gdir, store


def _sim(gdir, n_ctrl=6, topk=3):
    from code_robchar_tpu.mc import MCDataSim

    return MCDataSim("pipeline_cov", Nspin=4, inspin=0, outspin=2,
                     noises=np.linspace(0, 0.1, 2), bootreps=2,
                     numcontrollers=n_ctrl, filemarker=".le", topk=topk,
                     global_experiments_directory=gdir)


def test_datasim_pooling_slots_and_wd_data(tmp_path):
    gdir, _ = _seed_store(tmp_path)
    sim = _sim(gdir)
    pooled = sim.get_all_algo_controllers()
    # 2 ppo slots x 6 + lbfgs padded to 6
    assert pooled.shape == (18, 5)
    slots = sim._controller_slots()
    assert [n for n, _ in slots] == [6, 6, 4]
    assert all(c.shape == (6, 5) for _, c in slots)
    # short lbfgs store is FRONT-padded with zero rows
    assert np.all(slots[2][1][:2] == 0)

    sim.set_fig_save_directory(str(tmp_path / "figs"))
    assert sim.cur_save_folder == str(tmp_path / "figs")

    wd = sim.get_wd_data_c(algo="ppo")
    assert len(wd) == 3           # two sigma_train slots + lbfgs baseline
    assert all(w.shape[0] == 2 for w in wd)   # (noises, topk-filtered)


def test_datasim_tsne_cache_and_plot(tmp_path):
    gdir, _ = _seed_store(tmp_path)
    sim = _sim(gdir)
    emb = sim.tsne_embedding(perplexity=5, n_iter=300)
    assert emb.shape == (3, 6, 2)
    # second call hits the .tsne cache (bitwise round trip via JSON)
    emb2 = sim.tsne_embedding()
    np.testing.assert_allclose(emb2, emb, atol=1e-6)
    out = sim.tsneconts(fig_path=str(tmp_path / "tsne.png"))
    assert os.path.exists(out)


def test_datasim_merge_tools_and_get_path(tmp_path):
    from code_robchar_tpu.mc.datasim import DirectoryDoesNotExistError

    gdir, _ = _seed_store(tmp_path)
    sim = _sim(gdir)
    # seed a second experiment dir with one extra algo/noise cell
    rng = np.random.default_rng(1)
    from code_robchar_tpu.exp.namer import ExperimentNamer
    alt = ExperimentNamer(experiment_name="pipeline_cov2", Nspin=4,
                          inspin=0, outspin=2, numcontrollers=6,
                          global_dir=gdir)
    ctr = np.column_stack([rng.uniform(-10, 10, (6, 4)),
                           rng.uniform(1, 20, 6)]).tolist()
    json.dump({"ppo": {"0.1": {"controller": ctr}},
               "nmplus": {"0.0": {"controller": ctr}}},
              open(alt() + ".le", "w"))

    sim.merge_controller_files("pipeline_cov2")
    assert "nmplus" in sim.controllers
    assert "0.1" in sim.controllers["ppo"]

    with pytest.raises(DirectoryDoesNotExistError):
        sim.get_path("no_such_dir")
    with pytest.raises(ValueError, match="no such object"):
        sim.get_path("pipeline_cov", of="weird")

    # .mc/.mcm merge: generate caches in both dirs (the cache BASENAME
    # is experiment-independent — spin/transition/count only — so the
    # alt dir's caches already sit under the name merge_mcdata looks
    # for), then merge algo-wise
    sim2 = _sim(gdir)
    sim2.get_metrics_dict("0.0", algoname="ppo")
    from code_robchar_tpu.mc import MCDataSim as MCD
    other = MCD("pipeline_cov2", Nspin=4, inspin=0, outspin=2,
                noises=np.linspace(0, 0.1, 2), bootreps=2,
                numcontrollers=6, filemarker=".le", topk=3,
                global_experiments_directory=gdir)
    other.get_metrics_dict("0.0", algoname="nmplus")
    ours_mc = sim2.get_path("pipeline_cov", of="mc")[0]
    sim2.merge_mcdata("pipeline_cov2")
    merged = json.load(open(ours_mc))
    assert "ppo" in merged and "nmplus" in merged


def test_snob_skquant_fixed_ham_threshold_and_exhaustion():
    from code_robchar_tpu.models import SNOBSkquant

    # adaptive guard (snob_skquant.py:91-95)
    with pytest.raises(NotImplementedError, match="adaptive"):
        SNOBSkquant(4, 0, 2, testing=True, fid_noisy=True, adaptive=True)

    # threshold mode, reachable threshold: returns on first success with
    # the reference record schema
    opt = SNOBSkquant(4, 0, 2, testing=True, fid_threshold=0.05,
                      repeats=8, seed=3)
    fi = opt.run()
    assert fi is not None and fi > 0.05
    assert opt.record["func_calls"] % 300 == 0

    # fixed-ham billing: budget x train_size per restart
    opt2 = SNOBSkquant(4, 0, 2, testing=True, fid_threshold=0.0,
                       use_fixed_ham=True, opt_train_size=5,
                       run_until_told_to_stop=True,
                       run_until_completion_its=1500,
                       landscape_exploration=True, save_topc=4, seed=3)
    opt2.run()
    assert opt2.record["func_calls"] == 1500   # 300 * 5 after one restart

    # repeats exhausted without meeting the threshold: returns None
    opt3 = SNOBSkquant(4, 0, 2, testing=True, fid_threshold=2.0,
                       repeats=1, seed=3)
    assert opt3.run() is None


def test_rename_cli_entry(tmp_path, monkeypatch):
    """utils/rename.py __main__ block via runpy (lines 38-42)."""
    import runpy
    import sys

    bad = tmp_path / "a b[c].json"
    bad.write_text("{}")
    monkeypatch.setattr(sys, "argv", ["rename", str(tmp_path)])
    runpy.run_module("code_robchar_tpu.utils.rename",
                     run_name="__main__")
    assert not bad.exists()          # illegal chars sanitized


def test_trace_and_timed_contexts(tmp_path, capsys):
    from code_robchar_tpu.utils import trace as tr

    with tr.trace(str(tmp_path / "trc")):
        jnp.sum(jnp.ones(8)).block_until_ready()
    assert any(os.scandir(str(tmp_path / "trc")))
    with tr.timed("unit-tag"):
        pass
    assert "unit-tag" in capsys.readouterr().out


def test_actor_critic_aux_surfaces():
    from code_robchar_tpu.models import actor_critic as ac

    params = ac.init(jax.random.key(0), 5, 4)
    v = ac.critic(params, jnp.zeros(5))
    assert v.shape == ()
    a, val, logp = ac.policy_step(params, jnp.zeros(5), jax.random.key(1))
    assert a.shape == (4,) and np.isfinite(float(logp))
    assert ac.count_vars(params) > 0


def test_env_noisy_and_api_shims():
    from code_robchar_tpu.models.env import Environment

    env = Environment(4, 0, 2, ham_noisy=True, noise=0.05, fid_noisy=True,
                      adaptive=True, draws=20)
    env.reset()
    obs, reward, done = env.step(np.diag(np.asarray([1.0, -1.0, 0.5, 0.2])))
    assert 0.0 <= reward <= 1.0 + 1e-9
    assert env.adp_func_calls_increment >= 0
    f = env.fidelity()
    assert 0.0 <= f <= 1.0 + 1e-9
    tf = env.true_fid(np.diag(np.asarray([1.0, -1.0, 0.5, 0.2])), 5.0)
    assert 0.0 <= tf <= 1.0 + 1e-9

    from code_robchar_tpu.models.env import (EnvConfig,
                                             true_fidelity_batch)
    cfg = EnvConfig(n=4, in_spin=0, out_spin=2, bmax=10.0, maxtime=30.0,
                    noise=0.0, fid_noisy=False, ham_noisy=False,
                    draws=10, adaptive=False, adp_tol=0.01)
    stores = jnp.asarray([[1.0, -1.0, 0.5, 0.2, 5.0],
                          [0.0, 0.0, 0.0, 0.0, 2.0]])
    fids = true_fidelity_batch(cfg, jnp.real(env.sys), stores)
    assert fids.shape == (2,)


def test_config_x64_helpers():
    from code_robchar_tpu import config as cfg

    import jax as j
    old = j.config.jax_enable_x64
    try:
        cfg.enable_x64()
        assert j.config.jax_enable_x64
    finally:
        j.config.update("jax_enable_x64", old)


def test_generate_all_driver_with_stub_figures(tmp_path, monkeypatch):
    """The generate_all_figures.sh driver sequence (figs/generate_all.py)
    with stubbed figure classes + the ghostscript/copy grayscale leg."""
    import code_robchar_tpu.figs as figs_pkg
    from code_robchar_tpu.figs import generate_all as ga

    calls = []

    class _Stub:
        def __init__(self, name, **kw):
            calls.append((type(self).__name__, name))

        def _pdf(self, figname):
            p = tmp_path / "figs" / f"{figname}.pdf"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"%PDF-1.4\n%%EOF\n")
            return str(p)

        def plot_figs_3_6_10_11_12(self, noise_keys=None, figname="f"):
            return self._pdf(figname)

        def plot_fig3e(self, noise_keys=None, figname="f"):
            return self._pdf(figname)

        def plot_kendalltaus(self, noise_keys=None, figname="f"):
            return [self._pdf(figname)]

        def plot_grouped_boxplots(self, noise_keys=None, figname="f"):
            return self._pdf(figname)

        def get_ARIM_plot(self, figname="f"):
            return self._pdf(figname)

    class A(_Stub):
        pass

    class B(_Stub):
        pass

    class C(_Stub):
        pass

    monkeypatch.setattr(figs_pkg, "IndividualContComparisons", A)
    monkeypatch.setattr(figs_pkg, "KTRConsistency", B)
    monkeypatch.setattr(figs_pkg, "ARIMGenerator", C)
    paths = ga.generate_all(str(tmp_path / "exp"), str(tmp_path / "figs"),
                            nspin=4, outspin=2, numcontrollers=4,
                            bootreps=2, scaling_experiment=None,
                            grayscale=True)
    assert [c[0] for c in calls] == ["A", "B", "C"]
    # grayscale leg produced one gray/ copy per pdf
    grays = [p for p in paths if os.sep + "gray" + os.sep in p]
    assert grays and all(os.path.exists(p) for p in grays)

    # CLI main with the driver stubbed out
    import sys
    monkeypatch.setattr(ga, "generate_all", lambda *a, **k: ["x.pdf"])
    monkeypatch.setattr(sys, "argv", ["generate_all", "--no-gray"])
    ga.main()


def test_config_cache_default_dir_in_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to the fixed
    .jax_cache directory of the checkout."""
    import importlib

    from code_robchar_tpu import config as cfg

    old = jax.config.jax_compilation_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        monkeypatch.delenv("ROBCHAR_NO_COMPILATION_CACHE", raising=False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        jax.config.update("jax_compilation_cache_dir", None)
        importlib.reload(cfg)
        assert cfg.CACHE_DIR == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == cfg.CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_native_io_json_fallbacks(monkeypatch, tmp_path):
    """native_io with the codec unavailable (lib -> None) and the
    degenerate shapes that bypass it (0-d, empty): pure-json round
    trips must stay exact."""
    from code_robchar_tpu.utils import native_io as nio

    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_build_failed", True)

    arr = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(
        nio.decode_tensor(nio.encode_tensor(arr)), arr)

    path = str(tmp_path / "store.mc")
    nio.dump_mc({"a": arr, "b": np.arange(3.0)}, path)
    back = nio.load_mc(path)
    np.testing.assert_array_equal(back["a"], arr)
    np.testing.assert_array_equal(back["b"], np.arange(3.0))


def test_native_io_degenerate_shapes_use_json_path():
    from code_robchar_tpu.utils import native_io as nio

    empty = np.zeros((0, 3))
    assert nio.encode_tensor(empty) == "[]" or \
        json.loads(nio.encode_tensor(empty)) == []
    nine_d = np.zeros((1,) * 9)
    round9 = np.asarray(json.loads(nio.encode_tensor(nine_d)))
    assert round9.shape == (1,) * 9


def test_base_scalar_host_conveniences():
    """The jitted scalar host surface (fidelity_ss regimes,
    fidelity_ss_av, structured_perturabation, eval_static_fidelity_
    gradient, overlap_ss, wass_cost) — qnewton.py:383-455 mirrors."""
    from code_robchar_tpu.models import SNOB

    opt = SNOB(4, 0, 2, testing=True, ham_noisy=True, noise=0.05,
               draws=30)
    x = np.asarray([1.0, -2.0, 0.5, 3.0, 12.0])
    clean = opt.fidelity_ss(x)
    assert 0.0 <= clean <= 1.0
    noisy_h = opt.fidelity_ss(x, ham_noisy=True)
    assert noisy_h != clean
    shot = opt.fidelity_ss(x, noisy=True)
    assert shot * 30 == pytest.approx(round(shot * 30))
    opt.adaptive = True
    adp = opt.fidelity_ss(x, noisy=True)
    assert 0.0 <= adp <= 1.0
    opt.adaptive = False

    z = opt.structured_perturabation()
    assert np.allclose(np.asarray(z), np.asarray(z).T)

    opt2 = SNOB(4, 0, 2, testing=True, use_fixed_ham=True,
                opt_train_size=3, noise=0.05)
    av_train = opt2.fidelity_ss_av(x)
    av_test = opt2.fidelity_ss_av(x, test=True)
    assert 0.0 <= av_train <= 1.0 and 0.0 <= av_test <= 1.0
    fixed = opt2.fidelity_ss(x, use_fixed_ham=True,
                             rH=np.asarray(opt2.randH[0]))
    assert 0.0 <= fixed <= 1.0

    err, grad = opt.eval_static_fidelity_gradient(x)
    assert grad.shape == (5,) and 0.0 <= err <= 1.0
    ov = opt.overlap_ss(jnp.asarray(x))
    assert 0.0 <= ov <= 1.0
    wc = opt.wass_cost(jnp.asarray(x), bootstrap_reps=5)
    assert 0.0 <= wc <= 1.0
