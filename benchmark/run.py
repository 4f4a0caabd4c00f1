"""Run one benchmark cell on the accelerator and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix;
``cell.py`` reads them and ``drivers.py`` runs them.  Set-up (imports,
inputs made from the seed, one warm-up step that compiles or loads from
the persistent cache every program the window uses) is timed from the
start of this script.  The window then runs steps back to back for
``--seconds`` and divides all the work by all the time.  With
``--trace 1`` the window is traced (at most ``TRACE_SECONDS`` of it) and
the cell's per-layer metrics are read from the trace by the readers in
``metrics/``.  Once the window has closed and the device's peak memory
has been read, the driver's state is freed and what the timed steps
returned is compared with the float64 reference; each number compared is
printed beside its limit, last on standard error and last in the result
line.  The last line of standard output is the result as one JSON
object.  Without an accelerator, or with fewer devices than the cell
asks for, the script exits with a non-zero code and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from cell import (ROOT, CellError, card_power, compile_cache_dir,  # noqa
                  load_cell, load_reader, peaks_for)

if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

#: longest traced window: a trace of the steps of a few seconds is
#: enough to read shares from, and a longer one is slow to write and read
TRACE_SECONDS = 3.0
#: exit code of a run that cannot run here (no accelerator, too few)
NO_DEVICE = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class CompileCounter:
    """Counts the XLA programs JAX lowers (each then compiled, or loaded
    from the persistent cache) while ``on``."""

    EVENT = "/jax/core/compile/jaxpr_to_mlir_module_duration"

    def __init__(self):
        self.on, self.count = False, 0

    def __call__(self, event, *args, **kwargs):
        if self.on and event == self.EVENT:
            self.count += 1


def check_devices(jax, chips: int):
    """The devices the cell runs on; raises CellError without them."""
    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise CellError(f"JAX finds no device: {e}")
    if devs[0].platform != "gpu":
        raise CellError(f"no accelerator: JAX runs on {devs[0].platform!r}")
    if len(devs) < chips:
        raise CellError(f"the cell asks for {chips} devices, JAX finds "
                        f"{len(devs)}")
    peaks_for(devs[0].device_kind)
    return devs[:chips]


class Context:
    """What a per-layer reader reads: the reduced trace, the work done
    in the traced window, the compile counter, and the cell's files."""

    def __init__(self, trace, cell, work, compiles, peaks):
        self.trace, self.cell, self.work = trace, cell, work
        self.config, self.traffic = cell.config, cell.traffic
        self.compiles, self.peaks = compiles, peaks
        self.notes = []


def per_layer(cell, ctx):
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, require_chip: bool = True, root: str = ROOT) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload, root)
    except CellError as e:
        log(f"error: {e}")
        return 2

    import jax
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    import code_robchar_tpu  # noqa: F401  (sets its cache threshold)
    # every program of the cell, however quick to compile, is kept, so
    # that only the first run in a checkout compiles
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    counter = CompileCounter()
    jax.monitoring.register_event_duration_secs_listener(counter)

    if require_chip:
        try:
            devices = check_devices(jax, cell.chips)
        except CellError as e:
            log(f"error: {e}")
            return NO_DEVICE
        log(f"cards: {card_power()}")
    else:
        devices = jax.devices()[:cell.chips]
    kind = devices[0].device_kind
    peaks = peaks_for(kind) if require_chip else None

    from drivers import DRIVERS
    driver = DRIVERS[cell.traffic["driver"]](cell, args.seed)
    with jax.profiler.TraceAnnotation("bench:setup"):
        driver.setup()
    setup_s = time.perf_counter() - _T0
    log(f"setup_s {setup_s:.3f}")

    limit = min(args.seconds, TRACE_SECONDS) if args.trace else args.seconds
    trace_dir = tempfile.mkdtemp(prefix="bench_trace_") if args.trace \
        else None
    if trace_dir:
        # the host's own XLA runtime events label the idle gaps; Python
        # function tracing would slow a host-bound step several times
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0
        opts.enable_hlo_proto = False
        jax.profiler.start_trace(trace_dir, profiler_options=opts)
    work, steps = 0.0, 0
    counter.on = True
    with jax.profiler.TraceAnnotation("bench:window"):
        t0 = time.perf_counter()
        while True:
            with jax.profiler.TraceAnnotation("bench:step"):
                work += driver.step()
            steps += 1
            if time.perf_counter() - t0 >= limit:
                break
        elapsed = time.perf_counter() - t0
    counter.on = False
    if trace_dir:
        jax.profiler.stop_trace()
    log(f"window: {steps} steps, {work:.6g} {cell.traffic['metric']} "
        f"units in {elapsed:.4f} s ({work / elapsed:.6g} per s"
        f"{', traced' if trace_dir else ''}), {counter.count} programs "
        f"lowered")

    memory_peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                      for d in devices)
    driver.release()
    checks = driver.check()
    correct = all(v <= lim for _, v, lim in checks)

    device = {"platform": devices[0].platform, "kind": kind,
              "count": len(jax.devices()), "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": steps,
              "failed": int(getattr(driver, "failed", 0))}
    if args.trace:
        import trace_reduce
        red = trace_reduce.reduce_dir(trace_dir, devices=len(devices))
        shutil.rmtree(trace_dir, ignore_errors=True)
        ctx = Context(red, cell, work, counter.count, peaks)
        result["metrics"] = per_layer(cell, ctx)
        for note in ctx.notes:
            log(note)
        device.update(busy_s=red.busy_s, window_s=red.window_s)
        result["device"] = device
        result["breakdown"] = {"device_ops": red.top_ops(10),
                               "idle_gaps": red.idle_gaps(10)}
    else:
        result["metrics"] = {
            cell.traffic["metric"]: {"value": work / elapsed,
                                     "unit": _unit(cell, cell.traffic[
                                         "metric"])},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = device
    # JSON has no infinity: a reading that found nothing to compare
    # prints as the largest double, which fails any limit
    result["checks"] = {name: {"value": v if math.isfinite(v) else
                               sys.float_info.max, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        log(f"check {name} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


def _unit(cell, name):
    return next(m["unit"] for m in cell.end_to_end if m["name"] == name)


if __name__ == "__main__":
    sys.exit(main())
