"""Line-coverage harness on stdlib sys.monitoring (PEP 669, Python 3.12).

This container has no coverage/pytest-cov package; this collects line
coverage of ``code_robchar_tpu/`` with near-zero overhead by returning
``sys.monitoring.DISABLE`` after the first hit of each (code, line)
location — so the suite runs at essentially full speed.

Usage (from the repo root):

    python artifacts/covmon.py -m "not slow and not gpu" -q    # collect
    python artifacts/covmon.py --report                        # report

Collection writes ``artifacts/covmon_hits.json`` (merging into an
existing file, so the quick and slow tiers can be collected in separate
runs).  The report compares hits against each module's executable lines
(from the compiled code objects' ``co_lines``) and prints per-file
coverage with uncovered line runs.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "code_robchar_tpu")
HITS_PATH = os.path.join(REPO, "artifacts", "covmon_hits.json")


def collect(argv):
    # `python artifacts/covmon.py` puts artifacts/ at sys.path[0];
    # the package imports need the repo root (as `python -m pytest` has)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    hits: dict[str, set[int]] = {}
    mon = sys.monitoring
    tool = mon.COVERAGE_ID
    prefix = PKG + os.sep

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(prefix):
            hits.setdefault(fn, set()).add(line)
        return mon.DISABLE  # one event per location is all coverage needs

    mon.use_tool_id(tool, "covmon")
    mon.register_callback(tool, mon.events.LINE, on_line)
    mon.set_events(tool, mon.events.LINE)

    import pytest
    rc = pytest.main(argv)

    mon.set_events(tool, 0)
    merged: dict[str, list[int]] = {}
    if os.path.exists(HITS_PATH):
        merged = json.load(open(HITS_PATH))
    for fn, lines in hits.items():
        rel = os.path.relpath(fn, REPO)
        merged[rel] = sorted(set(merged.get(rel, [])) | lines)
    with open(HITS_PATH, "w") as f:
        json.dump(merged, f)
    print(f"covmon: wrote {HITS_PATH} ({len(merged)} files)")
    return rc


def executable_lines(path: str) -> set[int]:
    """All line numbers the compiler emits code for, recursively."""
    code = compile(open(path).read(), path, "exec")
    lines: set[int] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        # line 0 is the compiler's synthetic module header (RESUME) — not
        # a real source line
        lines.update(ln for _, _, ln in co.co_lines()
                     if ln is not None and ln > 0)
        for const in co.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def _runs(sorted_lines):
    out, start, prev = [], None, None
    for ln in sorted_lines:
        if start is None:
            start = prev = ln
        elif ln == prev + 1:
            prev = ln
        else:
            out.append((start, prev))
            start = prev = ln
    if start is not None:
        out.append((start, prev))
    return out


def report():
    hits = {k: set(v) for k, v in json.load(open(HITS_PATH)).items()}
    rows = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, REPO)
            exe = executable_lines(path)
            # a module's `def`/`class`/decorator lines execute at import;
            # docstring-only or empty modules report 100% trivially
            hit = hits.get(rel, set()) & exe
            missing = sorted(exe - hit)
            pct = 100.0 * len(hit) / len(exe) if exe else 100.0
            rows.append((pct, rel, len(exe), missing))
    rows.sort()
    total_exe = sum(r[2] for r in rows)
    total_missing = sum(len(r[3]) for r in rows)
    for pct, rel, n_exe, missing in rows:
        tag = ",".join(f"{a}" if a == b else f"{a}-{b}"
                       for a, b in _runs(missing))
        print(f"{pct:6.1f}%  {rel}  ({n_exe - len(missing)}/{n_exe})"
              + (f"  missing: {tag}" if missing else ""))
    print(f"\nTOTAL: {100.0 * (total_exe - total_missing) / total_exe:.1f}% "
          f"({total_exe - total_missing}/{total_exe} executable lines)")


if __name__ == "__main__":
    if "--report" in sys.argv:
        report()
    else:
        sys.exit(collect(sys.argv[1:]))
