"""p95_ms (ms): the 95th percentile (nearest rank) of every statement's
latency in the window; a statement that failed counts as missing it."""

import math

UNIT, LAYER, MOVES = "ms", None, None


def read(ctx):
    ms = sorted(math.inf if s["failed"] else s["ms"]
                for s in ctx["statements"])
    return ms[math.ceil(0.95 * len(ms)) - 1] if ms else None
