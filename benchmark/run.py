"""Run one cell of the benchmark once; the last line of standard output is
its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells are the ``workloads`` of ``BENCHMARK.json`` at the root of the
checkout. Exits 2, printing no result, without enough CUDA devices.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    return harness.main(a.workload, a.seed, a.seconds, bool(a.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
