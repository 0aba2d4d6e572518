"""Traffic kind ``external_sort``: the out-of-core sort of host-resident u32
keys, ``sort_external(keys, chunk=...)``, on a card whose memory other
tables hold: one host array made once from the seed, sorted again and
again, each call a numpy array in and a numpy array out.

Mix keys:
  call            "sort_external"
  rows, chunk     the configuration's keys a call and rows a round trip
  key             "u32"
  entropy_words   k: each key is the AND of k uniform words (1: uniform)
  check_pool      the call checked is drawn from the seed among the first
                  check_pool calls of the window (the last call is checked
                  too)
  trace_calls     the calls a --trace 1 run traces
  control         the control of this mix (``reference/external_sort.py``)

The keys are made on the card with plain torch (``cccl_sort``'s
generator), copied to a pageable host array and the card's copy freed.
The checked calls' outputs are host arrays already: they are kept, not
copied, so nothing is copied in the window. After it, every row of each
is compared with the reference's sort of the input rebuilt from the seed,
and the caller's array with that rebuilt input.
"""

from __future__ import annotations

import random

import numpy as np
import torch

import harness


class Cell:
    def __init__(self, rt, config: dict, mix: dict, *, seed: int, device,
                 reference):
        n, chunk = int(mix["rows"]), int(mix["chunk"])
        if (mix["call"] != "sort_external" or mix["key"] != config["key"]
                or (n, chunk) != (config["rows"], config["chunk"])):
            raise ValueError(f"{mix['call']} of {n} {mix['key']} rows in "
                             f"chunks of {chunk} is not the configuration's")
        self.rt, self.ref, self.device = rt, reference, device
        self.rows, self.chunk, self.seed = n, chunk, seed
        self.words = int(mix["entropy_words"])
        self.keys = self._input().view(torch.int32).cpu().numpy() \
            .view(np.uint32)
        if device.type == "cuda":  # the generator's buffers are not held
            torch.cuda.empty_cache()
        self.sample = random.Random(seed).randrange(int(mix["check_pool"]))
        self.kept: list = []  # outputs of the calls checked
        # the port's entry point takes the card by default; the CPU tests
        # run the same call on the kernels' plain versions
        self._kw = {} if device.type == "cuda" else {"device": "cpu"}
        self.fn = self._program
        self.layer = {"rows": n, "chunk": chunk, "runs": -(-n // chunk)}

    def _input(self) -> torch.Tensor:
        """The keys, on the card, as the seed makes them."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed % 2**64)
        words = harness.load("traffic", "cccl_sort").random_words
        return words(self.rows, torch.uint32, self.words, gen, self.device)

    def _program(self):
        return self.rt.sort_external(self.keys, chunk=self.chunk, **self._kw)

    def use_control(self, name: str) -> None:
        self.fn = lambda: self.ref.control(name, self.keys, self.chunk,
                                           device=self.device)

    def call(self, i: int):
        return self.fn()  # a host array: the call waited for the card

    def warm(self) -> None:
        out = self.call(0)
        del out

    def keep(self, i: int, out, last: bool) -> None:
        if i == self.sample or last:
            self.kept.append(out)

    def release(self) -> None:
        self.fn = None

    def _on_card(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.view(np.int32)).to(self.device) \
            .view(torch.uint32)

    def check(self) -> dict:
        """The most rows any checked call got wrong, and the rows of the
        caller's array that differ from the input (limits 0: the order is
        exact, the output a permutation of the input, the input left as
        it was)."""
        given = self._input()
        changed = self.ref.mismatched_rows(self._on_card(self.keys), given)
        want = self.ref.expected(given)
        del given
        worst = 0
        for got in self.kept:
            got = self._on_card(got)
            worst = max(worst, self.ref.mismatched_rows(got, want))
            del got
        return {"mismatched_rows": (worst, 0),
                "input_changed_rows": (changed, 0)}
