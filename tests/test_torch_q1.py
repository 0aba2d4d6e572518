"""TPC-H Q1 through the port's Query.run against the benchmark's plain
reference (benchmark/reference/tpch_q1.py).

The plan is the benchmark's own (benchmark/traffic/tpch_q1.py: where,
with_column, groupby_agg, with_column, order_by) over lineitem made by the
benchmark's generator at SF 0.01, for three values of DELTA. One more case
sets the lines' quantities and prices so that sum_qty passes 2^31 and
sum_charge 2^53: the answer must still be exact, so no sum may take an
int32 or a float route. Keys, sums and counts must match exactly, the
averages within the reference's AVG_RTOL (both sides divide one int64 sum
by one count in float64).
"""

import copy
import functools
import importlib.util
import json
import os

import pytest
import torch

import cuda.radixsort_tpu_torch as rt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 19


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "q1_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _modules():
    return _load("benchmark/traffic/tpch_q1.py"), \
        _load("benchmark/reference/tpch_q1.py")


@functools.cache
def _lineitem() -> dict:
    """Q1's lineitem at SF 0.01 (about 60,000 lines)."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "tpch_sf30_q1.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["scale_factor"] = 0.01
    kind, _ = _modules()
    return kind.make_lineitem(cfg, torch.Generator().manual_seed(SEED),
                              torch.device("cpu"))


def _assert_same(got: dict, want: dict, ref) -> None:
    assert ref.mismatched_rows(got, want) == 0
    for f in ref.EXACT:
        assert torch.equal(got[f].long(), want[f].long()), f
    assert got["sum_charge"].dtype == torch.int64
    assert got["avg_qty"].dtype == torch.float64


@pytest.mark.parametrize("delta", [60, 90, 120])
def test_q1_matches_the_reference(delta):
    kind, ref = _modules()
    lineitem = _lineitem()
    got = kind.Q1(rt, lineitem).run(delta)
    want = ref.q1(lineitem, delta)
    assert [chr(c) + chr(s) for c, s in zip(want["l_returnflag"].tolist(),
                                            want["l_linestatus"].tolist())] \
        == ["AF", "NF", "NO", "RF"]
    _assert_same(got, want, ref)


def test_q1_sums_past_2_31_and_2_53_are_exact():
    kind, ref = _modules()
    g = torch.Generator().manual_seed(SEED + 1)
    n = 6000
    lineitem = {
        "l_shipdate": torch.randint(2000, 2400, (n,), generator=g,
                                    dtype=torch.int32),
        # quantities near 2^30: sum_qty passes 2^31 within three lines
        "l_quantity": torch.randint(2**30 - 1000, 2**30, (n,), generator=g,
                                    dtype=torch.int32),
        # prices near 2^31: a line's charge is about 2.3e13, so about 400
        # lines of a group pass 2^53
        "l_extendedprice": torch.randint(2**31 - 10**6, 2**31 - 1, (n,),
                                         generator=g, dtype=torch.int32),
        "l_discount": torch.randint(0, 11, (n,), generator=g,
                                    dtype=torch.int8),
        "l_tax": torch.randint(0, 9, (n,), generator=g, dtype=torch.int8),
        "l_returnflag": torch.tensor([ord(c) for c in "ANR"],
                                     dtype=torch.uint8)[
            torch.randint(0, 3, (n,), generator=g)],
        "l_linestatus": torch.tensor([ord(c) for c in "FO"],
                                     dtype=torch.uint8)[
            torch.randint(0, 2, (n,), generator=g)],
    }
    got = kind.Q1(rt, lineitem).run(90)
    want = ref.q1(lineitem, 90)
    assert want["l_returnflag"].numel() == 6
    assert int(want["sum_qty"].min()) > 2**31
    assert int(want["sum_charge"].min()) > 2**53
    _assert_same(got, want, ref)
    # the reference's own sums, against Python's integers
    code = [(int(f), int(s)) for f, s in zip(lineitem["l_returnflag"],
                                             lineitem["l_linestatus"])]
    groups = sorted(set(code))
    charge = {k: 0 for k in groups}
    for k, p, d, t in zip(code, lineitem["l_extendedprice"].tolist(),
                          lineitem["l_discount"].tolist(),
                          lineitem["l_tax"].tolist()):
        charge[k] += p * (100 - d) * (100 + t)
    assert want["sum_charge"].tolist() == [charge[k] for k in groups]
