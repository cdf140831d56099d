"""Host calls that wait for the device (stream, device and event
synchronizations, synchronous copies) in the profiled ticks of a fleet
run, over those ticks."""

from portbench.lib import trace


def read(ctx):
    if ctx.get("kind") != "fleet" or not ctx.get("events"):
        return None
    return trace.count_syncs(ctx["events"]) / ctx["ticks"]
