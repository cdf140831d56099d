"""The share of the profiled ticks' wall in which the device ran nothing:
1 - (union of its operation intervals / wall), in %."""

from portbench.lib import trace


def read(ctx):
    if ctx.get("kind") != "fleet" or not ctx.get("events"):
        return None
    return 100.0 * (1.0 - trace.busy_us(ctx["events"]) / 1e6
                    / ctx["window_s"])
