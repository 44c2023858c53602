"""scatter_ms (ms/stream): device milliseconds of the colliding scatters,
per traced stream, from the profiler: the kernels of ``index_add_`` (the
segment sums and counts: ``indexFunc...`` with ``ReduceAdd``) and of
``scatter_reduce_`` / ``scatter_add_`` (the segment min/max:
``_scatter_gather_elementwise_kernel`` with a ``Reduce`` functor)."""

UNIT, LAYER, MOVES = "ms/stream", "ops", "qps"


def is_scatter(kernel: str) -> bool:
    if "indexFunc" in kernel:
        return "ReduceAdd" in kernel
    return "_scatter_gather_elementwise_kernel" in kernel and \
        "Reduce" in kernel


def read(ctx):
    streams = ctx.get("streams") or []
    if not streams:
        return None
    total = sum(v for st in streams for k, v in st.kernel_device_s.items()
                if is_scatter(k))
    return 1e3 * total / len(streams)
