"""Share of the device's busy time spent outside the Jacobi kernels (%):
the optimizer loop's own operations (two-loop recursion, line search,
lane refill) and the result evaluation."""

from rooflines import outside_kernels


def read(ctx):
    return outside_kernels(ctx)
