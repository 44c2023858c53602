#!/usr/bin/env python3
"""Device time of ``sorted_probe`` under other launch plans, on one CUDA card.

    python3 tools/sorted_probe_sweep.py [--samples 5]

At the shapes ``chip_smoke.py`` measures (Q14's probe, SF1's lineitem ->
orders probe in table order and shuffled) and at 6 M shuffled probes into
1.5 M keys drawn from a log-normal (skewed) distribution, prints one JSON
line per (shape, plan) with the kernel's device time (``chip_smoke.
device_ms``: median of ``--samples`` profiler windows of 10 calls), the
plan ``cuda_kernels.sorted_probe_plan`` picks marked ``"chosen"``, and per
shape the device time of ``torch.searchsorted`` and of a launch with
n_valid = 0 (reads every probe and writes every position, searches
nothing: the floor under any search).  Every plan's result is checked
against ``torch.searchsorted`` first.  It runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sorted_probe_sweep: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.ops import cuda_kernels as CK

    C.SAMPLES = args.samples
    card = C.card_line()
    CK.build()
    launch = CK._launcher("sorted_probe")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(keys, probes, n_valid, plan, out):
        a = CK._ProbeArgs()
        a[:] = (keys.data_ptr(), keys.shape[0], 0, n_valid,
                probes.data_ptr(), probes.shape[0], out.data_ptr(), *plan,
                CK._stream(0))
        CK._raise_on(launch(a), "sorted_probe")

    _, shapes = C.path_inputs(torch, LocalRunner(scale_factor=1.0))
    gen = torch.Generator(device="cpu").manual_seed(1)
    skewed = torch.sort((torch.randn(1_500_000, generator=gen,
                                     dtype=torch.float64) * 4).exp()
                        .mul(1e6).to(torch.int64)).values.cuda()
    shapes["lognormal_shuffled"] = (skewed, skewed[torch.randint(
        0, skewed.shape[0], (6_000_000,), generator=gen).cuda()], None)

    for name, (keys, probes, _) in shapes.items():
        n, p = keys.shape[0], probes.shape[0]
        want = torch.searchsorted(keys, probes).to(torch.int32)
        out = torch.empty_like(want)
        chosen = CK.sorted_probe_plan(p, sms)
        if p < 2 * sms * 1024:
            plans = [(-(-p // t), t, lg) for t in (64, 128, 256)
                     for lg in range(0, 9, 2)]
        else:
            plans = [(b * sms, t, lg) for b, t in ((1, 1024), (2, 1024),
                                                   (2, 512))
                     for lg in range(4, 9)]
        plans = sorted(set(plans) | {chosen})
        ref = C.device_ms(torch, {
            "searchsorted": lambda: torch.searchsorted(keys, probes),
            "floor": lambda: run(keys, probes, 0, chosen, out)})
        print(json.dumps({"shape": name, "n": n, "p": p, "card": card,
                          **{f"{k}_ms": v for k, v in ref.items()}}),
              flush=True)
        for plan in plans:
            run(keys, probes, n, plan, out)
            if not torch.equal(out, want):
                raise AssertionError(f"{name} {plan}: differs from "
                                     "torch.searchsorted")
            ms = C.device_ms(torch, {"k": lambda: run(keys, probes, n, plan,
                                                      out)})["k"]
            print(json.dumps({"shape": name, "plan": plan,
                              "chosen": plan == chosen, "device_ms": ms}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
