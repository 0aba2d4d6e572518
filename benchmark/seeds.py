"""Read a cell's compared numbers over many seeds in one process, for the
program or for a control in its place: the readings its limits are set
from. Not part of a benchmark run.

    python3 benchmark/seeds.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control <name>]

One JSON line per seed: whether it was correct, each number compared with
its limit, and the calls made. A control's name is that of its mix
(``control`` in ``benchmark/traffic/<traffic>.json``) or another of its
reference's.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", default=None)
    a = p.parse_args(argv)
    import torch

    import port

    if not torch.cuda.is_available():
        print("seeds: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.benchmark_spec()
    w, config, mix = harness.cell_spec(spec, a.workload)
    device = torch.device("cuda", 0)
    rt = port.load(harness.ROOT)
    port.build_kernels()
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.monotonic()
        r = harness.run_cell(rt, w, config, mix, seed=seed,
                             seconds=a.seconds, trace=False, device=device,
                             t0=t0, metrics=spec["end_to_end"],
                             control=a.control)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": a.control, "correct": r["correct"],
                          "checks": r["checks"], "calls": r.get("calls"),
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()},
                          "peak": r["device"]["memory_peak_bytes"],
                          "seconds": time.monotonic() - t0}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
