"""The share of the profiled requests' wall in which the device ran
nothing: 1 - (union of its operation intervals / wall), in %."""

from portbench.lib import trace


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("events"):
        return None
    return 100.0 * (1.0 - trace.busy_us(ctx["events"]) / 1e6
                    / ctx["window_s"])
