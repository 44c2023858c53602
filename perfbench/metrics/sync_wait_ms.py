"""sync_wait_ms (ms/stmt): the host's wait on its counted device-to-host
reads, per statement: the inclusive time of the program's ``host_read``
spans (``presto_tpu_torch/utils/tracing.py``) over its ``statement``
spans, both recorded only while the profiler ran, that is in the traced
streams.  What ``host_syncs`` costs in time.  None from a program without
spans, or where none was recorded (the CPU)."""

UNIT, LAYER, MOVES = "ms/stmt", "runner and operators", "geomean_ms"


def value(totals):
    stmts = totals.get("statement", (0, 0, 0))[0]
    if not stmts:
        return None
    return totals.get("host_read", (0, 0, 0))[1] / 1e6 / stmts


def read(ctx):
    try:
        from presto_tpu_torch.utils import tracing
    except ImportError:
        return None
    return value(tracing.totals())
