"""Pipeline-driver tests (exp/drivers.py).

The drivers are the CLI entry points mirroring the reference's __main__
blocks (noise_analysis.py:441-490, run_stoch_experiments.py:4-32).  One
test executes the `collect` driver for real at a tiny budget (all four
families, slow tier); the rest pin the argv -> Experiment wiring of every
command with a recording stub, so flag-forwarding regressions fail fast
without paying for compute.
"""

import json
import os

import numpy as np
import pytest

from code_robchar_tpu.exp import drivers


def test_collect_driver_end_to_end(tmp_path, monkeypatch):
    """`python -m ...drivers collect` at a tiny budget: full four-family
    collection through the real Experiment, writing the .le store under
    ./experiments (the reference's cwd-relative layout)."""
    monkeypatch.chdir(tmp_path)
    exp = drivers.run_experiments_single_controller_set_with_le([
        "--exp_name", "pipeline_drv", "--nspin", "4", "--inspin", "0",
        "--outspin", "2", "--num_controllers", "2",
        "--fid_threshold", "0.0", "--run_until_completion_its", "400",
        "--noise_res", "2", "--max_noise", "0.1"])
    assert os.path.exists(exp.filename)
    assert exp.filename.endswith(".le")
    data = json.load(open(exp.filename))
    assert set(data) >= {"lbfgs", "nmplus", "snob", "ppo"}
    # lbfgs keyed by str(Nspin), others by noise value (SURVEY quirk 8)
    assert "4" in data["lbfgs"]
    cell = list(data["nmplus"].values())[0]
    assert len(cell["controller"]) == 2
    assert len(cell["controller"][0]) == 5  # N + 1 controls


class _RecordingExperiment:
    """Stub standing in for exp.Experiment: records construction kwargs
    and which driver method ran, performs no compute."""

    instances = []

    def __init__(self, exp_name, **kw):
        self.exp_name = exp_name
        self.kw = kw
        self.calls = []
        _RecordingExperiment.instances.append(self)

    def __getattr__(self, name):
        def method(*a, **k):
            self.calls.append((name, a, k))
        return method


@pytest.fixture
def recorder(monkeypatch):
    _RecordingExperiment.instances = []
    monkeypatch.setattr(drivers, "Experiment", _RecordingExperiment)
    return _RecordingExperiment


@pytest.mark.quick
def test_var_noise_driver_wiring(recorder):
    drivers.run_controller_getter_without_landscape_exploration([
        "--exp_name", "pipeline_vn", "--nspin", "5", "--inspin", "0",
        "--outspin", "4", "--algo_name", "nmplus",
        "--num_controllers", "7", "--noise_res", "3",
        "--max_noise", "0.2", "--draws", "50"])
    (exp,) = recorder.instances
    assert exp.exp_name == "pipeline_vn"
    assert exp.kw["Nspin"] == 5 and exp.kw["outspin"] == 4
    assert exp.kw["runs"] == 7 and exp.kw["draws"] == 50
    np.testing.assert_allclose(exp.kw["noises"],
                               np.linspace(0, 0.2, 3))
    assert exp.calls == [("run_var_noise", ("nmplus",), {})]


@pytest.mark.quick
def test_arim_scaling_driver_wiring(recorder):
    """run_stoch_experiments.py:4-32 parity: the noise grid depends on
    use_fixed_ham, the exp name is fixed, and the nstoch sampler runs."""
    drivers.run_arim_scaling_experiments([
        "--nspin", "5", "--inspin", "0", "--outspin", "2",
        "--num_controllers", "100",
        "--run_until_completion_its", "40000000",
        "--records_update_rate", "100000", "--use_fixed_ham", "false"])
    drivers.run_arim_scaling_experiments([
        "--nspin", "5", "--inspin", "0", "--outspin", "2",
        "--num_controllers", "100",
        "--run_until_completion_its", "40000000",
        "--records_update_rate", "100000", "--use_fixed_ham", "true",
        "--fixed_ham_train_size", "100"])
    nonstoch, stoch = recorder.instances
    for exp in (nonstoch, stoch):
        assert exp.exp_name == "pipeline_nonstoch_experiments_others_comp"
        assert exp.kw["records_update_rate"] == 100000
        assert exp.kw["run_until_completion_its"] == 40000000
        assert exp.calls == [
            ("singlerun_ccollector_nstoch_sampling", (), {})]
    np.testing.assert_allclose(nonstoch.kw["noises"],
                               [0.0, 0.01, 0.05, 0.1])
    np.testing.assert_allclose(stoch.kw["noises"], [0.01, 0.05, 0.1])
    assert stoch.kw["use_fixed_ham"] is True
    assert stoch.kw["opt_train_size"] == 100


@pytest.mark.quick
def test_paper_data_driver_wiring(recorder, monkeypatch):
    """get_paper_data.sh:4-43 parity: seven transitions then the two
    4e7-fcall scaling runs, respawn enabled everywhere."""
    drivers.run_paper_data(budget=1234, controllers=9)
    assert len(recorder.instances) == len(drivers.PAPER_TRANSITIONS) + 2
    for exp, (n, out) in zip(recorder.instances,
                             drivers.PAPER_TRANSITIONS):
        assert exp.exp_name == f"pipeline_spin_{n}_0-{out}"
        assert exp.kw["Nspin"] == n and exp.kw["outspin"] == out
        assert exp.kw["runs"] == 9
        assert exp.kw["run_until_completion_its"] == 1234
        assert exp.kw["respawn_from_checkpoint"] is True
        assert exp.calls == [("singlerun_ccollector", (), {})]
    scaling = recorder.instances[-2:]
    assert [e.kw["use_fixed_ham"] for e in scaling] == [False, True]


@pytest.mark.quick
def test_ppo_test_driver_wiring(recorder):
    """noise_analysis.py:480-487 parity: the four (lam, gamma) probes."""
    drivers.run_ppo_test()
    (exp,) = recorder.instances
    assert exp.exp_name == "pipeline_ppo_experiments_2"
    assert len(exp.calls) == 4
    lams = [k["custom_args"]["lam"] for _, _, k in exp.calls]
    gammas = [k["custom_args"]["gamma"] for _, _, k in exp.calls]
    assert lams == [0.8, 0.2, 0.8, 0.2]
    assert gammas == [0.8, 0.8, 0.2, 0.2]


@pytest.mark.parametrize("extra,want", [
    ([], [("singlerun_ccollector", (), {})]),
    (["--algos", "ppo,lbfgs,nmplus,snob,adam"],
     [("singlerun_ccollector",
       (["ppo", "lbfgs", "nmplus", "snob", "adam"],), {})]),
])
def test_collect_algos_flag_through_main(recorder, extra, want):
    """`drivers.main(argv)` runs `collect` in-process; `--algos` picks the
    families (default: the reference's four)."""
    drivers.main(["collect", "--exp_name", "x", "--nspin", "7",
                  "--outspin", "6", "--num_controllers", "1000"] + extra)
    (exp,) = recorder.instances
    assert exp.kw["Nspin"] == 7 and exp.kw["runs"] == 1000
    assert exp.calls == want


def test_main_rejects_unknown_command():
    with pytest.raises(SystemExit):
        drivers.main(["nope"])
