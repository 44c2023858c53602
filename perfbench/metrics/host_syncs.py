"""host_syncs (syncs/stmt): the program's own count of device-to-host
reads of each statement (``LocalRunner.last_host_syncs``), averaged over
the window's statements. Each read stalls the host until the device
drains."""

UNIT, LAYER, MOVES = "syncs/stmt", "runner and operators", "geomean_ms"


def read(ctx):
    syncs = [s["host_syncs"] for s in ctx["statements"] if not s["failed"]]
    return sum(syncs) / len(syncs) if syncs else None
