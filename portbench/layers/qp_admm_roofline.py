"""K1 (the ADMM QP kernel) against its roofline: the least time an H100
could take for one launch's work, counted from the cell's own shapes (B
lanes, m = 3 control_steps, the QP's iterations), over K1's mean device
time a launch in the profiled ticks, in %."""

from portbench.lib import bounds, trace


def read(ctx):
    if ctx.get("kind") != "fleet" or not ctx.get("events"):
        return None
    durs = trace.kernel_durations_us(ctx["events"], "qp_admm")
    if not durs:
        return None
    least_ms = bounds.qp_admm_work(ctx["lanes"], ctx["m"],
                                   ctx["qp_iters"])["bound_ms"]
    return 100.0 * least_ms * 1e3 / (sum(durs) / len(durs))
