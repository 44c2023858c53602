"""peak_mem_gib (GiB): ``torch.cuda.max_memory_allocated()`` over the
window, reset at its start: the resident tables plus the largest working
set of a statement."""

UNIT, LAYER, MOVES = "GiB", None, None


def read(ctx):
    return ctx["window_peak_bytes"] / 2**30
