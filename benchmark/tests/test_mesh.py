"""The four-rank Q3 cell (``traffic/tpch_mesh.py``) on the CPU at SF 0.01:
its partitions against the whole tables, its blocked reference against
``reference/tpch_q3.py``, its control and a run of the cell over a gloo
world of four processes, and the distributed layer's three metric
readers, with and without the program's counter and ranges."""

import copy
import os
import time
from types import SimpleNamespace

import pytest
import torch

import harness
from tracing import DeviceOp

SEED = 2**31 + 31
CELL = "tpch_q3_sf300_mesh4"
CPU = torch.device("cpu")


def mesh_config(sf: float = 0.01) -> dict:
    cfg = copy.deepcopy(harness.read_json(os.path.join(
        harness.BENCH, "configs", "tpch_sf300_mesh4.json")))
    cfg["scale_factor"] = sf
    return cfg


@pytest.fixture
def kind(monkeypatch):
    """The traffic kind, in chunks small enough that SF 0.01 has several."""
    mod = harness.load("traffic", "tpch_mesh")
    monkeypatch.setattr(mod, "CHUNK_ORDERS", 4096)
    monkeypatch.setattr(mod, "CHUNK_CUSTOMERS", 512)
    return mod


def whole(kind, cfg) -> dict:
    cust = list(kind.customer_chunks(cfg, SEED, CPU))
    chunks = list(kind.order_chunks(cfg, SEED, CPU))
    return {"customer": {k: torch.cat([c[k] for c in cust]) for k in cust[0]},
            "orders": {k: torch.cat([o[k] for o, _, _ in chunks])
                       for k in chunks[0][0]},
            "lineitem": {k: torch.cat([li[k] for _, li, _ in chunks])
                         for k in chunks[0][1]}}


def rows(cols: dict) -> list:
    return sorted(zip(*(cols[k].tolist() for k in sorted(cols))))


def test_the_ranks_partitions_are_the_whole_tables(kind):
    cfg = mesh_config()
    tables = whole(kind, cfg)
    assert tables["orders"]["orderkey"].numel() == 15000
    assert tables["customer"]["custkey"].tolist() == list(range(1, 1501))
    parts = [kind.make_partition(cfg, SEED, r, 4, CPU) for r in range(4)]
    key = {"customer": "custkey", "orders": "orderkey",
           "lineitem": "orderkey"}
    for t, cols in tables.items():
        counts = [p[t][key[t]].numel() for p in parts]
        assert len(set(counts)) > 1  # hash partitions: unequal
        for r, p in enumerate(parts):  # each rank holds its own rows only
            assert bool((kind.owner(p[t][key[t]], 4) == r).all())
        union = {k: torch.cat([p[t][k] for p in parts]) for k in cols}
        assert rows(union) == rows(cols)


def test_fmix32_is_murmur3s_finaliser(kind):
    def fmix(h):  # murmur3's fmix32, in Python integers
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    keys = [0, 1, 2, 31, 2**31 - 1, 1800000000]
    got = kind.fmix32(torch.tensor(keys, dtype=torch.int32)).tolist()
    assert got == [fmix(k) for k in keys]


@pytest.mark.parametrize("pairs", [[(1, "1995-03-15"), (0, "1995-03-01"),
                                    (4, "1995-03-31"), (2, "1995-03-09")]])
def test_the_blocked_reference_is_tpch_q3(kind, pairs):
    ref = harness.load("reference", "tpch_q3_mesh")
    plain = harness.load("reference", "tpch_q3")
    cfg = mesh_config()
    tables = whole(kind, cfg)
    params = [(s, kind.day(d)) for s, d in pairs]
    blocks = ((o, li) for o, li, _ in kind.order_chunks(cfg, SEED, CPU))
    got = ref.answers(tables["customer"], blocks, params, 10)
    for p in params:
        want = plain.q3(tables, *p, 10)
        assert len(want["orderkey"]) == 10
        assert ref.mismatched_rows(got[p], want) == 0
        for f in ref.FIELDS:
            assert got[p][f].tolist() == want[f].tolist()


def run(rt, control=None, trace=False):
    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, CELL)
    cfg = dict(cfg, scale_factor=0.01)
    metrics = (harness.metrics_of(spec, "end_to_end", CELL) if not trace
               else [m for m in harness.metrics_of(spec, "per_layer", CELL)
                     if m["source"] == "program_counter"])
    return harness.run_cell(rt, w, cfg, dict(mix, trace_calls=2), seed=SEED,
                            seconds=0.5, trace=trace, device=CPU,
                            t0=time.monotonic(), metrics=metrics,
                            control=control)


def test_the_cell_is_correct_and_its_control_is_not(rt):
    r = run(rt)
    assert r["correct"] and r["calls"] >= 1
    assert r["checks"]["mismatched_rows"]["value"] == 0
    assert set(r["metrics"]) == {"peak_mem_per_row", "setup_s"}
    c = run(rt, control="rank0_only")
    assert not c["correct"] and c["checks"]["mismatched_rows"]["value"] > 0


def test_a_traced_run_reads_the_bytes_sent(rt):
    r = run(rt, trace=True)
    assert r["correct"]
    assert r["metrics"]["exchange.bytes_per_row"]["value"] > 0


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def ctx_of(**kw):
    base = dict(state={}, calls=2, on_card=True, layer={"rank_rows": 1000},
                trace=SimpleNamespace(ops=[]))
    base.update(kw)
    return SimpleNamespace(**base)


OPS = [DeviceOp("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)", 0.0,
                400.0, ("comm.all_to_all", "exchange_rows", "_dist_join_hash",
                        "Query.run")),
       DeviceOp("ncclDevKernel_AllGather_RING_LL", 500.0, 600.0,
                ("comm.all_gather", "_dist_gather", "Query.run")),
       DeviceOp("void at::native::elementwise_kernel<128, 2>", 600.0, 650.0,
                ("comm.all_to_all", "exchange_rows", "_dist_join_hash")),
       DeviceOp("void at::native::index_elementwise_kernel", 700.0, 900.0,
                ("exchange_rows", "_dist_join_hash", "Query.run")),
       DeviceOp("void at::native::vectorized_elementwise_kernel", 900.0,
                1000.0, ("_dist_groupby_agg", "Query.run")),
       DeviceOp("void stage_onesweep<32, false>", 1000.0, 3000.0,
                ("sort_pairs", "_dist_join_hash", "Query.run")),
       DeviceOp("void at::native::reduce_kernel", 3000.0, 3300.0,
                ("groupby_multi", "_dist_groupby_agg", "Query.run")),
       DeviceOp("void at::native::copy_kernel", 3300.0, 3400.0,
                ("_run_distributed", "Query.run"))]


def comm_module(rt):
    import importlib

    return importlib.import_module(f"{rt.__name__}.parallel.comm")


def test_bytes_per_row_is_the_counters_delta_per_call_and_row(rt,
                                                             monkeypatch):
    mod = harness.load("metrics", "exchange.bytes_per_row")
    comm = comm_module(rt)
    monkeypatch.setattr(comm, "SENT_BYTES", 10**9)
    ctx = ctx_of()
    mod.start(ctx)
    monkeypatch.setattr(comm, "SENT_BYTES", 10**9 + 60000)
    assert mod.read(ctx) == 30.0  # 60000 B over 2 calls over 1000 rows
    monkeypatch.delattr(comm, "SENT_BYTES")  # a program without it
    ctx = ctx_of()
    mod.start(ctx)
    assert mod.read(ctx) is None


def test_exchange_roofline_is_the_bytes_over_the_link_rate(rt, monkeypatch):
    mod = harness.load("metrics", "exchange.roofline_pct")
    comm = comm_module(rt)
    card = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(mod.torch.cuda, "get_device_name", lambda i=0: card)
    monkeypatch.setattr(comm, "SENT_BYTES", 0)
    ctx = ctx_of(trace=SimpleNamespace(ops=OPS))
    mod.start(ctx)
    monkeypatch.setattr(comm, "SENT_BYTES", 90000000)
    # 90 MB at 450 GB/s is 200 us, against 500 us of the nccl kernels
    assert mod.read(ctx) == pytest.approx(40.0)
    monkeypatch.setattr(mod.torch.cuda, "get_device_name",
                        lambda i=0: "a card with no rate")
    assert mod.read(ctx) is None
    monkeypatch.delattr(comm, "SENT_BYTES")
    ctx = ctx_of(trace=SimpleNamespace(ops=OPS))
    mod.start(ctx)
    assert mod.read(ctx) is None
    with pytest.raises(RuntimeError, match="device metric"):
        mod.read(ctx_of(on_card=False))


def test_dist_glue_is_the_distributed_layers_own_torch_ops():
    mod = harness.load("metrics", "dist.glue_ms")
    ctx = ctx_of(trace=SimpleNamespace(ops=OPS))
    # the copy under comm.all_to_all, the gather under exchange_rows and
    # the op under _dist_groupby_agg: 50 + 200 + 100 us over 2 calls; not
    # the nccl kernels, the stage kernel, an operator's op or the plan's
    assert mod.read(ctx) == pytest.approx(0.175)
    no_comm = [DeviceOp(op.name, op.start, op.end,
                        tuple(r for r in op.ranges
                              if not r.startswith("comm.")))
               for op in OPS]
    assert mod.read(ctx_of(trace=SimpleNamespace(ops=no_comm))) is None
