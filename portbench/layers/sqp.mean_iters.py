"""The mean of the program's own SimResult.solver_iters over every
lane-tick of the window."""


def read(ctx):
    if ctx.get("kind") != "fleet":
        return None
    return ctx.get("mean_iters")
