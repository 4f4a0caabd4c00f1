"""Share of the device's busy time spent outside the Jacobi kernels (%):
noise draw, Hamiltonian assembly and the metric reduction."""

from rooflines import outside_kernels


def read(ctx):
    return outside_kernels(ctx)
