"""Shared arithmetic of the kernel readers in ``metrics/``."""

from __future__ import annotations

import re

import work


def is_jacobi(name: str) -> bool:
    return name.startswith("jacobi_")


def kernel_roofline(ctx, kind: str, elements: float, label: str):
    """100 x least seconds for ``elements`` elements of ``kind`` over the
    summed device time of the kernel ``jacobi_<kind>_n<n>``; None where
    the trace holds no such kernel."""
    n = ctx.config["nspin"]
    name = f"jacobi_{kind}_n{n}"
    pat = re.compile(re.escape(name) + r"(?!\d)")
    seconds = ctx.trace.op_seconds(lambda op: pat.match(op) is not None)
    if seconds <= 0 or elements <= 0 or ctx.peaks is None:
        return None
    least, bound = work.least_seconds(kind, n, ctx.config["sweeps"],
                                      elements, ctx.peaks)
    ctx.notes.append(f"{label}: {name} {seconds:.6f} s for {elements:.6g} "
                     f"elements, {bound}-bound, least {least:.6f} s")
    return 100.0 * least / seconds


def outside_kernels(ctx):
    """100 x the device's busy time outside the Jacobi kernels over its
    busy time; None where the device was never busy."""
    busy = ctx.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.union_seconds(is_jacobi) / busy)
