"""Kernel-launch calls (runtime or driver API, every thread) in the
profiled ticks of a fleet run, over those ticks."""

from portbench.lib import trace


def read(ctx):
    if ctx.get("kind") != "fleet" or not ctx.get("events"):
        return None
    return trace.count_launches(ctx["events"]) / ctx["ticks"]
