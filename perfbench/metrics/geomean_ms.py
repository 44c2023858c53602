"""geomean_ms (ms): the geometric mean of every statement's latency in
the window, from ``execute`` to the last row fetched (TPC-H's Power@Size
is 3600 * SF over this mean)."""

import math

UNIT, LAYER, MOVES = "ms", None, None


def read(ctx):
    ms = [s["ms"] for s in ctx["statements"]]
    return math.exp(sum(math.log(m) for m in ms) / len(ms)) if ms else None
