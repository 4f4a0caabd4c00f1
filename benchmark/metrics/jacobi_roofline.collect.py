"""Share of its roofline that the symmetric Jacobi gradient kernel
reaches (%): the least time the chip needs for the objective-and-gradient
evaluations the traced runs billed (the traffic's ``evals_per_fcall``,
the reference's accounting) over the kernel's summed device time."""

from rooflines import kernel_roofline


def read(ctx):
    per = ctx.traffic.get("evals_per_fcall")
    if per is None:
        return None
    return kernel_roofline(ctx, "sym_grad", ctx.work * per,
                           "jacobi_roofline.collect")
