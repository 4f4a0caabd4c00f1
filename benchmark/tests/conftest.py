"""Benchmark tests run on the CPU (four virtual devices, for the mesh
cell) with the benchmark's own modules and the program importable.  The
cells they run are tiny copies of the benchmark's, written into a
scratch checkout root by the ``tiny_root`` fixture."""

import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

import pytest  # noqa: E402

TINY_CHAR = {"driver": "characterise", "metric": "hamiltonians_per_s",
             "controllers": 2048, "bootreps": 8,
             "noise_levels": {"start": 0.0, "stop": 0.1, "num": 3},
             "mesh_devices": 1, "check_top_controllers": 4,
             "check_blocks": 4, "check_cells_per_block": 2}
TINY_COLLECT = {"driver": "collect", "metric": "fcalls_per_s",
                "family": "lbfgs", "fcall_budget": 20000, "save_topc": 20,
                "sigma_train": 0.0, "fid_threshold": 0.1,
                "evals_per_fcall": 0.5, "check_top_kept": 9,
                "control_restarts": 32}


def tiny_cells():
    """{cell: (config, traffic dict)}: the benchmark's cells at a size a
    test can hold, with the limits of the traffic they shrink."""
    def limits(name):
        with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
            return json.load(f)["limits"]
    mesh = dict(TINY_CHAR, mesh_devices=4,
                limits=limits("characterise_4gpu"))
    return {
        "chain7_0-6.tiny_char": ("chain7_0-6", dict(
            TINY_CHAR, limits=limits("characterise"))),
        "chain10_0-2.tiny_char": ("chain10_0-2", dict(
            TINY_CHAR, limits=limits("characterise"))),
        "chain7_0-6.tiny_char4": ("chain7_0-6", mesh),
        "chain7_0-6.tiny_lbfgs": ("chain7_0-6", dict(
            TINY_COLLECT, limits=limits("collect_lbfgs"))),
    }


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A scratch checkout root holding a BENCHMARK.json of tiny cells; the
    compilation cache goes under it too."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (tmp_path / "benchmark" / "traffic").mkdir(parents=True)
    shutil.copytree(os.path.join(BENCH, "configs"),
                    tmp_path / "benchmark" / "configs")
    workloads = []
    for name, (config, traffic) in tiny_cells().items():
        tname = name.split(".", 1)[1]
        with open(tmp_path / "benchmark" / "traffic" / f"{tname}.json",
                  "w") as f:
            json.dump(traffic, f)
        workloads.append({"name": name, "config": config, "traffic": tname,
                          "chips": traffic.get("mesh_devices", 1),
                          "why": "test"})
    bench["workloads"] = workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    return str(tmp_path)
