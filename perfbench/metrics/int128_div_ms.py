"""int128_div_ms (ms/stmt): host time of the program's int128 divisions
per statement: the inclusive time of its ``int128_div`` spans
(``ops/int128.py`` ``udivmod`` and ``div_round_half_up``; a nested one
opens no span of its own, so each division counts once) over its
``statement`` spans; recorded only in the traced streams.  None from a
program without spans, or where none was recorded (the CPU)."""

UNIT, LAYER, MOVES = "ms/stmt", "ops", "geomean_ms"


def value(totals):
    stmts = totals.get("statement", (0, 0, 0))[0]
    if not stmts:
        return None
    return totals.get("int128_div", (0, 0, 0))[1] / 1e6 / stmts


def read(ctx):
    try:
        from presto_tpu_torch.utils import tracing
    except ImportError:
        return None
    return value(tracing.totals())
