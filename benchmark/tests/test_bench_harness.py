"""Whole runs of the harness at tiny sizes on the CPU (the look for a chip
skipped): a sound run is correct, and a run whose timed path is broken
underneath is not, once for each fault its cell can have."""

import json

import jax
import jax.numpy as jnp
import pytest

import run
from code_robchar_tpu.mc import engine
from code_robchar_tpu.models import base, objectives
from code_robchar_tpu.ops import realform
from code_robchar_tpu.parallel import mesh as pmesh
from code_robchar_tpu.utils import record

SEED = "2147483659"
RIM = r"$W(.,\delta(x-1))$"


def run_cell(root, cell, capsys, trace=0):
    jax.clear_caches()
    base._PROGRAM_CACHE.clear()
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.2",
                   "--trace", str(trace)], require_chip=False, root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err
    result = json.loads(out.out.strip().splitlines()[-1])
    # the numbers compared, each with its limit, close standard error and
    # the result line
    assert list(result)[-1] == "checks"
    for name, c in result["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in out.err
    return result


@pytest.mark.parametrize("cell", ["chain7_0-6.tiny_char",
                                  "chain10_0-2.tiny_char",
                                  "chain7_0-6.tiny_char4",
                                  "chain7_0-6.tiny_lbfgs"])
def test_sound_run_is_correct(tiny_root, capsys, cell):
    res = run_cell(tiny_root, cell, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "hamiltonians_per_s"} or \
        set(res["metrics"]) == {"setup_s", "fcalls_per_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_traced_run_reports_per_layer_metrics_only(tiny_root, capsys):
    res = run_cell(tiny_root, "chain7_0-6.tiny_char", capsys, trace=1)
    assert res["correct"] is True
    # the CPU has no device plane: only the compile counter has something
    # to read
    assert res["metrics"] == {"jit_compiles_in_window.mc":
                              {"value": 0, "unit": "programs"}}
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_no_accelerator_no_result(tiny_root, capsys):
    rc = run.main(["--workload", "chain7_0-6.tiny_char", "--seed", "1",
                   "--seconds", "1"], root=tiny_root)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no accelerator" in out.err


def test_unknown_workload_is_refused(tiny_root, capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                    root=tiny_root) != 0
    assert capsys.readouterr().out == ""


# -------------------------------------------------------------- faults

def no_sweeps(monkeypatch):
    """The eigensolver returns its state unchanged."""
    monkeypatch.setattr(realform, "_sweeps_for", lambda dtype, n: 0)


def half_batch(monkeypatch):
    """The metrics are reduced over half of each cell's bootstrap reps."""
    orig = engine.metric_tensors

    def half(fids, alpha=0.05):
        return orig(fids[..., :fids.shape[-1] // 2], alpha)
    monkeypatch.setattr(engine, "metric_tensors", half)


def altered_answer(monkeypatch):
    """The eigensolver's fidelity is altered in one lane of every 16 where
    it is produced (as a kernel that mishandles one lane of a block)."""
    orig = realform.fidelity_herm_lanes

    def altered(*args, **kwargs):
        return orig(*args, **kwargs).at[::16].add(0.05)
    monkeypatch.setattr(realform, "fidelity_herm_lanes", altered)


def no_exchange(monkeypatch):
    """Each card's block stays its own: the result holds card 0's block
    in every card's place."""
    orig = pmesh.sharded_mc_metrics

    def local(mesh, *args, **kwargs):
        out = orig(mesh, *args, **kwargs)
        n_dev = mesh.devices.size

        def first(v):
            c = v.shape[1] // n_dev
            return jnp.tile(jnp.asarray(v)[:, :c], (1, n_dev))
        return {k: first(v) for k, v in out.items()}
    monkeypatch.setattr(pmesh, "sharded_mc_metrics", local)


@pytest.mark.parametrize("cell,fault", [
    ("chain7_0-6.tiny_char", no_sweeps),
    ("chain7_0-6.tiny_char", half_batch),
    ("chain7_0-6.tiny_char", altered_answer),
    ("chain10_0-2.tiny_char", no_sweeps),
    ("chain10_0-2.tiny_char", half_batch),
    ("chain10_0-2.tiny_char", altered_answer),
    ("chain7_0-6.tiny_char4", no_sweeps),
    ("chain7_0-6.tiny_char4", half_batch),
    ("chain7_0-6.tiny_char4", altered_answer),
    ("chain7_0-6.tiny_char4", no_exchange),
])
def test_characterise_fault_is_caught(tiny_root, capsys, monkeypatch, cell,
                                      fault):
    fault(monkeypatch)
    res = run_cell(tiny_root, cell, capsys)
    assert res["correct"] is False
    assert res["checks"]["metric_gap"]["value"] > \
        res["checks"]["metric_gap"]["limit"]


def frozen_optimizer(monkeypatch):
    """The gradient kernel returns nothing to move on: every restart
    keeps its starting point."""
    orig = objectives.make_exact_gradient_batch

    def frozen(spec):
        f = orig(spec)

        def g(xs):
            err, grad = f(xs)
            return err, jnp.zeros_like(grad)
        return g
    monkeypatch.setattr(objectives, "make_exact_gradient_batch", frozen)


def altered_best(monkeypatch):
    """The best fidelity a run reports is altered where it is recorded."""
    orig = record.RunRecord.save

    def save(self, **kw):
        kw["best_fid"] = kw["best_fid"] - 0.01
        return orig(self, **kw)
    monkeypatch.setattr(record.RunRecord, "save", save)


@pytest.mark.parametrize("fault,number", [(frozen_optimizer, "top_ascent"),
                                          (altered_best, "best_fid_gap")])
def test_collect_fault_is_caught(tiny_root, capsys, monkeypatch, fault,
                                 number):
    fault(monkeypatch)
    res = run_cell(tiny_root, "chain7_0-6.tiny_lbfgs", capsys)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
