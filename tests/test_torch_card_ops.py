"""The port held on the CPU to what the card's torch can run.

Every case of the surface table (tests/torch_surface.py, the one chip_smoke.py
runs card against CPU in its ``surface`` phase) runs here through the port
on the CPU under ``UnsignedGuard``: an operator that the card's torch
refuses on uint16/32/64 tensors (``CARD_UNSIGNED_GAPS``, probed on the card
by chip_smoke.py's ``card_ops`` phase) fails the case even where CPU torch
has it. Each case runs at its smallest size above 1 (1 where it has no
other); its result must equal the same call outside the guard, bit for
bit. The table's coverage rule holds here too: every public name of the
swept modules is in a case or in EXCLUDED with a reason."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_surface as surf

# A parallel run's workers (pytest -n) share the machine's cores, and every
# worker imports every test module: torch keeps to one thread in each.
torch.set_num_threads(1)

CASES = surf.all_cases()


def _guard_size(case) -> int:
    """The case's smallest size above 1 (a size of 1 takes the early
    returns), or 1 where it has no other."""
    return min((n for n in case.sizes if n > 1), default=1)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_case_runs_under_the_card_op_guard(case):
    n = _guard_size(case)
    inputs = surf.case_inputs(case, n)
    guard = surf.UnsignedGuard()
    with guard:
        got = surf.run_case(case, n, "cpu", inputs)
    assert guard.hits == [], (case.id, n, guard.hits)
    want = surf.run_case(case, n, "cpu", inputs)
    diff = surf.compare(_bit_for_bit(case), got, want, inputs)
    assert diff is None, (case.id, n, diff)
    assert surf.devices_of(got) <= {"cpu"}


def _bit_for_bit(case):
    """The same case compared bit for bit: both runs are on the CPU."""
    return dataclasses.replace(case, compare="bits")


def test_every_public_name_is_in_a_case_or_excluded():
    missing, stale, stale_excluded = surf.uncovered(CASES)
    assert missing == [], f"public names in no surface case: {missing}"
    assert stale == [], f"case covers that name no public name: {stale}"
    assert stale_excluded == [], f"EXCLUDED names nothing: {stale_excluded}"
    assert all(reason for reason in surf.EXCLUDED.values())
    assert len(surf.swept_names()) >= 250


def test_table_meets_every_dtype_engine_order_and_size():
    """The sort family's trimming rule: every key dtype meets every engine
    and both orders, and every size runs at least once per engine (the
    reference engine up to REFERENCE_MAX)."""
    met, sizes = set(), {}
    for c in CASES:
        if not c.id.startswith(("sort[", "argsort[")) or "bits" in c.id:
            continue
        dt, eng, order = c.id[c.id.index("[") + 1:-1].split(",")
        met.add((dt, eng, order))
        sizes.setdefault(eng, set()).update(c.sizes)
    assert met == {(d, e, o) for d in surf.KEY_DTYPES for e in surf.ENGINES
                   for o in ("asc", "desc")}
    for eng in surf.ENGINES:
        want = {n for n in surf.SIZES
                if eng != "reference" or n <= surf.REFERENCE_MAX}
        assert sizes[eng] == want, eng
    pay = {c.id.split("+")[1].split(",")[0] for c in CASES
           if c.id.startswith("sort_pairs[") and "+" in c.id}
    assert set(surf.PAYLOAD_DTYPES) <= pay
    ids = [c.id for c in CASES]
    assert len(ids) == len(set(ids))
    assert all(c.needs == surf._needs(c.id) for c in CASES)


@pytest.mark.parametrize("op", sorted(surf.CARD_UNSIGNED_GAPS))
def test_guard_refuses_each_gap(op):
    """Each operator of the table, called the way the card's probe calls
    it, is refused on uint32 on the CPU (before CPU torch is reached)."""
    fn = surf._probe_ops()[op]
    g = np.random.default_rng(3)
    a = torch.from_numpy(g.integers(0, 50, 64)).to(torch.uint32)
    b = torch.from_numpy(g.integers(1, 50, 64)).to(torch.uint32)
    i = torch.from_numpy(g.integers(0, 64, 16))
    m = torch.from_numpy(g.integers(0, 2, 64).astype(bool))
    guard = surf.UnsignedGuard()
    with pytest.raises(surf.CardOpError), guard:
        fn(a, b, i, m)
    assert guard.hits and guard.hits[0][0] == op


def test_guard_lets_signed_views_and_slices_through():
    u = torch.arange(10, dtype=torch.int32).view(torch.uint32)
    s = u.view(torch.int32)
    with surf.UnsignedGuard() as guard:
        assert (s < 5).sum() == 5
        assert torch.equal(u[2:4].view(torch.int32), s[2:4])
        assert torch.equal(torch.cat([u, u]).view(torch.int32)[:10], s)
        assert bool((u == u).all())
        s[torch.tensor([1])] = 7
        _ = torch.where(s > 3, s, s)
    assert guard.hits == []


def test_probe_on_the_cpu_lists_only_known_ops():
    """The probe runs here too: what CPU torch refuses is a subset of the
    probe's op names (the card's answer is checked by chip_smoke.py)."""
    got = surf.probe_card_ops("cpu")
    assert set(got) <= set(surf.PROBE_OPS)
    assert set(surf.CARD_UNSIGNED_GAPS) <= set(surf.PROBE_OPS)
    assert all(v == ("uint16", "uint32", "uint64")
               for v in surf.CARD_UNSIGNED_GAPS.values())
