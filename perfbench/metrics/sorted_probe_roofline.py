"""sorted_probe_roofline (%): the least time the card's bandwidth allows
for every ``sorted_probe`` launch of the traced streams (bytes from each
launch's shapes, ``roofline/sorted_probe.py``, over the peak in
``peaks.json``) as a share of the kernel's device time in the trace.
Nothing is returned where the kernel did not run."""

UNIT, LAYER, MOVES = "%", "kernels", "geomean_ms"
KERNEL = "sorted_probe"


def read(ctx):
    streams = ctx.get("streams") or []
    launches = [x for st in streams for x in st.launches.get(KERNEL, [])]
    busy = sum(v for st in streams for k, v in st.kernel_device_s.items()
               if KERNEL in k)
    if not launches or busy <= 0:
        return None
    model = ctx["roofline"](KERNEL)
    peak = ctx["peak"]
    bound = sum(max(model.bytes_moved(**x) / peak["hbm_bytes_per_s"],
                    model.operations(**x) / peak["int_ops_per_s"])
                for x in launches)
    return 100.0 * bound / busy
