"""``python -m cuda.radixsort_tpu_torch [--device cpu]``: a one-command
self-test.

Sorts 2^20 random u32 keys against ``torch.sort``, runs a small query plan
(where -> groupby mean -> order_by -> limit), and prints one JSON status
line. It runs on the CUDA card unless ``--device cpu`` is given, and exits
non-zero when a check fails or no card is present."""

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m cuda.radixsort_tpu_torch")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device; pass --device cpu"}))
        return 2

    import cuda.radixsort_tpu_torch as rt

    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(0)
    wide = torch.randint(0, 1 << 32, (1 << 20,), dtype=torch.int64,
                         device=device, generator=gen)
    keys = wide.to(torch.int32).view(torch.uint32)
    out = rt.sort(keys)
    want = torch.sort(wide).values
    sort_ok = bool(torch.equal(out.view(torch.int32).to(torch.int64)
                               & 0xFFFFFFFF, want))

    small = wide[: 1 << 16]
    t = rt.table(k=(small % 100).to(torch.int32).view(torch.uint32),
                 v=(small % 1000).to(torch.int32))
    q = (rt.Query(t).where(lambda t: t["v"] > 500)
         .groupby("k", "v", agg="mean").order_by("v", descending=True)
         .limit(3))
    _, cnt, _ = q.run()
    query_ok = int(cnt) == 3

    print(json.dumps({
        "version": rt.__version__,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "sort_1M_ok": sort_ok,
        "query_plan_ok": query_ok,
        "seconds": round(time.time() - t0, 1),
    }))
    return 0 if (sort_ok and query_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
