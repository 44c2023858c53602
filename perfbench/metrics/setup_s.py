"""setup_s (s): from the process's start to the window's start: tables
made, the connection opened, the stream run once (plans, uploads, the
kernels' build on a checkout's first run)."""

UNIT, LAYER, MOVES = "s", None, None


def read(ctx):
    return ctx["setup_s"]
