"""What one benchmark cell is made of, read from the files that name it.

``BENCHMARK.json`` at the checkout's root lists the cells.  A cell names
a configuration (``configs/<name>.json``: the problem instance and its
sizes) and a traffic mix (``traffic/<name>.json``: which driver of
``drivers.py`` runs it, with what parameters, and the limits of its
correctness comparison).  Per-layer metrics are readers in
``metrics/<name>.py``.  A new cell of an existing driver is data only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class CellError(Exception):
    """The cell cannot run here: unknown name, missing file, or a device
    that is absent or not in the peak table."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # entries of BENCHMARK.json that this cell reports
    per_layer: list


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CellError(f"missing file {os.path.relpath(path, ROOT)}")


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, traffic_metric: str) -> bool:
    """Whether a per-layer metric is read in ``cell``, whose traffic
    reports the end-to-end metric ``traffic_metric``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] == traffic_metric


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with its
    configuration and its traffic (``<root>/benchmark/traffic/``)."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, confs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                      w["traffic"] + ".json"))
    rate = traffic["metric"]
    e2e = [m for m in bench["end_to_end"] if m["name"] in ("setup_s", rate)]
    layer = [m for m in bench["per_layer"] if _reports(m, name, rate)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def load_reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", metric_name + ".py")
    if not os.path.exists(path):
        raise CellError(f"no reader for per-layer metric {metric_name!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks_for(device_kind: str) -> dict:
    """Published peaks of ``device_kind`` from peaks.json; an unknown
    device is an error."""
    table = _load_json(os.path.join(BENCH_DIR, "peaks.json"))["devices"]
    if device_kind not in table:
        raise CellError(f"device {device_kind!r} is not in peaks.json; "
                        f"known: {sorted(table)}")
    return table[device_kind]


def card_power() -> str:
    """The cards' names and power limits as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(out.stdout.strip().splitlines()) or out.stderr.strip()


def compile_cache_dir(environ=os.environ) -> str:
    """JAX's persistent compilation cache: JAX_COMPILATION_CACHE_DIR
    where it is set, else a fixed directory in the checkout (the path is
    part of the cache key, so it never moves)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or \
        os.path.join(ROOT, ".jax_cache")
