"""result_rows_ms (ms/stmt): host time building each statement's result
rows: the self time of the program's ``result_rows`` spans
(``runner.materialize``'s host columns, the cursor's ``to_pydict`` and
row tuples), without the ``host_read`` spans inside them, over its
``statement`` spans; recorded only in the traced streams.  None from a
program without spans, or where none was recorded (the CPU)."""

UNIT, LAYER, MOVES = "ms/stmt", "client edge", "qps"


def value(totals):
    stmts = totals.get("statement", (0, 0, 0))[0]
    if not stmts:
        return None
    return totals.get("result_rows", (0, 0, 0))[2] / 1e6 / stmts


def read(ctx):
    try:
        from presto_tpu_torch.utils import tracing
    except ImportError:
        return None
    return value(tracing.totals())
