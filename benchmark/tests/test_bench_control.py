"""The control of each driver's comparison at a size a test can hold: the
program reads inside the traffic's limits, and the reference computed in
bfloat16 in the program's place reads outside them.  (The readings that
set the limits were taken on the chip at the cells' own sizes with
benchmark/control.py; PERF.md gives them.)"""

import pytest

import jax

from cell import load_cell
from drivers import DRIVERS
from code_robchar_tpu.models import base


def readings(root, name, seed):
    jax.clear_caches()
    base._PROGRAM_CACHE.clear()
    cell = load_cell(name, root)
    d = DRIVERS[cell.traffic["driver"]](cell, seed)
    d.setup()
    d.step()
    d.release()
    program = {k: (v, lim) for k, v, lim in d.check()}
    return program, d.control()


@pytest.mark.parametrize("name", ["chain7_0-6.tiny_char",
                                  "chain10_0-2.tiny_char",
                                  "chain7_0-6.tiny_char4"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_characterise_control_fails(tiny_root, name, seed):
    program, control = readings(tiny_root, name, seed)
    value, limit = program["metric_gap"]
    assert value < limit
    assert control["metric_gap"] > limit


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_collect_control_fails(tiny_root, seed):
    program, control = readings(tiny_root, "chain7_0-6.tiny_lbfgs", seed)
    assert all(v <= lim for v, lim in program.values())
    assert any(control[k] > program[k][1] for k in control)
