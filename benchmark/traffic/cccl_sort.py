"""Traffic kind ``cccl_sort``: the calls of CCCL's nvbench radix-sort suite
(``cub/benchmarks/bench/radix_sort/keys.cu`` and ``pairs.cu``): one input
made once on the card, sorted again and again, as nvbench times it.

Mix keys:
  call            "sort" (keys only) or "sort_pairs" (stable, one payload)
  rows            the suite's ``Elements{io}``
  key, value      "u32" / "u64"; value null for keys only
  entropy_words   k: each key is the AND of k uniform words, so a bit is 1
                  with probability 2^-k (CCCL's ``Entropy`` 1.000, 0.811,
                  0.544, 0.337, 0.201 for k = 1..5)
  check_pool      the call checked is drawn from the seed among the first
                  check_pool calls of the window (the last call is checked
                  too)
  trace_calls     the calls a --trace 1 run traces
  control         the control of this mix (``reference/cccl_sort.py``)
"""

from __future__ import annotations

import random

import torch

DTYPES = {"u32": torch.uint32, "u64": torch.uint64}


def random_words(n: int, dtype: torch.dtype, k: int, gen: torch.Generator,
                 device) -> torch.Tensor:
    """n values of a 4- or 8-byte dtype, each the AND of k uniform words."""
    words = n * dtype.itemsize // 4
    out = None
    for _ in range(k):
        w = torch.randint(-2**31, 2**31, (words,), dtype=torch.int32,
                          generator=gen, device=device)
        out = w if out is None else out.bitwise_and_(w)
    return out.view(dtype)


class Cell:
    def __init__(self, rt, config: dict, mix: dict, *, seed: int, device,
                 reference):
        n = int(mix["rows"])
        lo, hi = config["elements"]
        if not lo <= n <= hi or mix["key"] not in config["key_types"]:
            raise ValueError(f"{n} {mix['key']} rows lie outside the "
                             f"configuration's axes")
        if (mix["call"] == "sort_pairs") != bool(mix.get("value")):
            raise ValueError(f"{mix['call']} with value {mix.get('value')}")
        self.rt, self.ref, self.device, self.rows = rt, reference, device, n
        gen = torch.Generator(device=device).manual_seed(seed % 2**64)
        self.keys = random_words(n, DTYPES[mix["key"]],
                                 int(mix["entropy_words"]), gen, device)
        self.values = (random_words(n, DTYPES[mix["value"]], 1, gen, device)
                       if mix.get("value") else None)
        self.sample = random.Random(seed).randrange(int(mix["check_pool"]))
        self.kept: list = []  # outputs of the calls checked
        self.fn = self._program
        key_bytes = self.keys.dtype.itemsize
        value_bytes = self.values.dtype.itemsize if self.values is not None \
            else 0
        self.layer = {"rows": n, "key_limbs": key_bytes // 4,
                      "planes": (key_bytes + value_bytes) // 4,
                      "row_bytes": key_bytes + value_bytes}
        # a pinned host copy of the sampled call's outputs: the check must
        # not hold a second output on the card while the window runs
        pin = device.type == "cuda"
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                      for t in (self.keys, self.values) if t is not None]

    def _program(self):
        if self.values is None:
            return (self.rt.sort(self.keys),)
        k, v = self.rt.sort_pairs(self.keys, self.values)
        return (k, v)

    def use_control(self, name: str) -> None:
        self.fn = lambda: self.ref.control(name, self.keys, self.values)

    def call(self, i: int):
        out = self.fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def warm(self) -> None:
        for i in range(2):
            out = self.call(i)
            del out

    def keep(self, i: int, out, last: bool) -> None:
        if i == self.sample:
            for h, t in zip(self._host, out):
                h.copy_(t)
            self.kept.append(self._host)
        if last:
            self.kept.append(list(out))

    def release(self) -> None:
        self.fn = None

    def check(self) -> dict:
        """The most rows any checked call got wrong (limit 0: the order is
        exact, and ties keep their input order)."""
        want = self.ref.expected(self.keys, self.values)
        worst = 0
        for got in self.kept:
            got = [t.to(self.device) for t in got]
            worst = max(worst, self.ref.mismatched_rows(got, want))
            del got
        return {"mismatched_rows": (worst, 0)}
