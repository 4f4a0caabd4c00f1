"""Share of its roofline that the Hermitian Jacobi fidelity kernel
reaches (%): the least time the chip needs for the lattice elements the
traced window characterised (work.py, the configuration's nominal
sweeps) over the kernel's summed device time."""

from rooflines import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "herm_fid", ctx.work, "jacobi_roofline.mc")
