"""Kernel-launch calls on every thread (the server's included) in the
profiled requests, over those requests."""

from portbench.lib import trace


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("events"):
        return None
    return trace.count_launches(ctx["events"]) / ctx["requests"]
