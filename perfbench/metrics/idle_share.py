"""idle_share (%): the share of the traced streams' wall time in which
no operation ran on the device (1 - busy / wall), busy being the union
of every kernel, memset and memcpy the profiler recorded."""

UNIT, LAYER, MOVES = "%", "device", "qps"


def read(ctx):
    streams = ctx.get("streams") or []
    wall = sum(st.wall_s for st in streams)
    busy = sum(st.busy_s for st in streams)
    return 100.0 * (1.0 - busy / wall) if wall > 0 and busy > 0 else None
