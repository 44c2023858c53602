"""operator_self_ms (ms/stmt): the operators' own host time per
statement: the self time of the program's ``op:<Operator>`` spans
(``presto_tpu_torch/utils/tracing.py``), that is each operator's span
less its child spans (child operators, ``host_read``, ``int128_div``,
``result_rows``), over its ``statement`` spans; recorded only in the
traced streams.  Dispatch of the operators' kernels, and the waits no
``host_read`` counts.  None from a program without spans, or where none
was recorded (the CPU)."""

UNIT, LAYER, MOVES = "ms/stmt", "runner and operators", "geomean_ms"


def value(totals):
    stmts = totals.get("statement", (0, 0, 0))[0]
    if not stmts:
        return None
    own = sum(t[2] for name, t in totals.items() if name.startswith("op:"))
    return own / 1e6 / stmts


def read(ctx):
    try:
        from presto_tpu_torch.utils import tracing
    except ImportError:
        return None
    return value(tracing.totals())
