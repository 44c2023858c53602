"""qps (statements/s): statements completed in the window over the
window's seconds, taken by the host clock. The window closes when the
last statement started before its end returns, so every statement's work
and all of the window's time count."""

UNIT, LAYER, MOVES = "statements/s", None, None


def read(ctx):
    done = [s for s in ctx["statements"] if not s["failed"]]
    return len(done) / ctx["window_s"] if ctx["window_s"] > 0 else None
