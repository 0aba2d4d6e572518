"""Traffic kind ``tpch_mesh``: a TPC-H query through the port's distributed
plan (``Table.from_partition``, ``Query.run(mesh=)``) over ranks that each
hold their own hash partition of the tables, one card a rank.

The harness's process is rank 0 on ``cuda:0``. The ``Cell`` starts ranks
1..n-1 as processes of this file (``cuda:1``.. on the card, the CPU in the
tests), which join one world: NCCL for the data (gloo on the CPU) and a
gloo group for the harness's orders, with a time limit on both. Each rank
makes only its own partition from the seed. On every call rank 0
broadcasts the call's parameters, every rank runs the query, and rank 0
returns the answer. ``release()`` stops the ranks. A rank exits as soon
as its parent does (``PR_SET_PDEATHSIG`` and a watch on the parent's
pid), and rank 0 exits at once when a rank fails, so a program that
cannot run the cell fails soon and leaves no process behind.

The tables are those of the ``tpch`` kind, by the same distributions and
constants (``tables``), made in chunks that do not depend on the number
of ranks: chunk k of the orders holds orders [k*CHUNK, (k+1)*CHUNK) with
all their lines, drawn from a generator seeded by (seed, k), and the
customers come in chunks the same way. Placement, the configuration's
``deployment``: a customer lives on rank fmix32(custkey) mod ranks, an
order and its lines on rank fmix32(orderkey) mod ranks (murmur3's 32-bit
finaliser). The program is not told the placement.

Mix keys are the ``tpch`` kind's; ``control`` ``rank0_only`` answers from
rank 0's partition alone, as a plan that skipped its exchanges would.
"""

from __future__ import annotations

import datetime
import json
import os
import random
import subprocess
import sys
import threading
import time

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harness  # noqa: E402

tpch = harness.load("traffic", "tpch")
day, PACK = tpch.day, tpch.PACK

CHUNK_ORDERS = 1 << 23  # orders a chunk (about 4x as many lines)
CHUNK_CUSTOMERS = 1 << 24
TIMEOUT_S = 300  # a collective or an order waits at most this long
STOP, RUN = 0, 1
_MASK32 = 0xFFFFFFFF


def fmix32(keys: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser of the keys' low 32 bits, as int64."""
    x = keys.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def owner(keys: torch.Tensor, ranks: int) -> torch.Tensor:
    return fmix32(keys) % ranks


def _chunk_gen(seed: int, table: int, k: int, device) -> torch.Generator:
    """The generator of chunk k of a table (0 customer, 1 orders): one
    stream per (seed, table, chunk), whatever the number of ranks."""
    x = (seed * 0x9E3779B97F4A7C15 + table * 0xBF58476D1CE4E5B9 + k) \
        & (2**64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return torch.Generator(device=device).manual_seed(x ^ (x >> 31))


def sizes(config: dict) -> dict:
    t, sf = config["tables"], config["scale_factor"]
    return {"customer": int(t["customer_per_sf"] * sf),
            "orders": int(t["orders_per_sf"] * sf),
            "part": int(t["part_per_sf"] * sf)}


def customer_chunks(config: dict, seed: int, device):
    """The customer table, chunk by chunk: {column: tensor}."""
    n = sizes(config)["customer"]
    for k, a in enumerate(range(0, n, CHUNK_CUSTOMERS)):
        b = min(a + CHUNK_CUSTOMERS, n)
        gen = _chunk_gen(seed, 0, k, device)
        yield {"custkey": torch.arange(a + 1, b + 1, dtype=torch.int32,
                                       device=device),
               "c_mktsegment": torch.randint(
                   0, len(config["segments"]), (b - a,), dtype=torch.int8,
                   generator=gen, device=device)}


def order_chunks(config: dict, seed: int, device):
    """The orders and lineitem tables, chunk by chunk: (orders, lineitem,
    of_line), each order's lines in its chunk; of_line is each line's
    order within the chunk."""
    t = config["tables"]
    sz = sizes(config)
    n_cust, n_ord, n_part = sz["customer"], sz["orders"], sz["part"]
    for k, a in enumerate(range(0, n_ord, CHUNK_ORDERS)):
        b = min(a + CHUNK_ORDERS, n_ord)
        gen = _chunk_gen(seed, 1, k, device)

        def rand(lo, hi, n, dtype=torch.int32):  # uniform in [lo, hi]
            return torch.randint(lo, hi + 1, (n,), dtype=dtype,
                                 generator=gen, device=device)

        used, every = t["order_key_sparsity"]
        i = torch.arange(a, b, dtype=torch.int64, device=device)
        orderkey = ((i // used) * every + i % used + 1).to(torch.int32)
        del i
        mortality = t["cust_mortality"]
        r = rand(0, n_cust - n_cust // mortality - 1, b - a)
        o_custkey = (r // (mortality - 1)) * mortality \
            + r % (mortality - 1) + 1
        del r
        o_orderdate = rand(day(t["orderdate_first"]),
                           day(t["orderdate_last"]), b - a)
        orders = {"orderkey": orderkey, "custkey": o_custkey,
                  "o_orderdate": o_orderdate,
                  "o_shippriority": torch.zeros(b - a, dtype=torch.int32,
                                                device=device)}
        lo, hi = t["lines_per_order"]
        lines = rand(lo, hi, b - a)
        n_line = int(lines.sum())
        of_line = torch.repeat_interleave(
            torch.arange(b - a, dtype=torch.int32, device=device), lines,
            output_size=n_line)
        del lines
        lo, hi = t["ship_days"]
        l_shipdate = o_orderdate.index_select(0, of_line) \
            + rand(lo, hi, n_line)
        l_orderkey = orderkey.index_select(0, of_line)
        lo, hi = t["discount_pct"]
        l_discount = rand(lo, hi, n_line, torch.int8)
        partkey = rand(1, n_part, n_line)
        retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
        del partkey
        lo, hi = t["quantity"]
        l_extendedprice = rand(lo, hi, n_line) * retail
        del retail
        lineitem = {"orderkey": l_orderkey, "l_shipdate": l_shipdate,
                    "l_extendedprice": l_extendedprice,
                    "l_discount": l_discount}
        yield orders, lineitem, of_line


def make_partition(config: dict, seed: int, rank: int, ranks: int,
                   device) -> dict:
    """Rank ``rank``'s partition of every table: {table: {column:
    tensor}}, the rows the placement gives it, in chunk order."""
    parts: dict = {"customer": [], "orders": [], "lineitem": []}
    for cust in customer_chunks(config, seed, device):
        keep = (owner(cust["custkey"], ranks) == rank).nonzero().squeeze(1)
        parts["customer"].append({k: v[keep] for k, v in cust.items()})
    for orders, lineitem, of_line in order_chunks(config, seed, device):
        mine = owner(orders["orderkey"], ranks) == rank
        keep_o = mine.nonzero().squeeze(1)
        keep_l = mine[of_line].nonzero().squeeze(1)
        parts["orders"].append({k: v[keep_o] for k, v in orders.items()})
        parts["lineitem"].append({k: v[keep_l] for k, v in lineitem.items()})
        del orders, lineitem, of_line, mine, keep_o, keep_l
    out = {}
    for name, chunks in parts.items():
        out[name] = {k: torch.cat([c[k] for c in chunks])
                     for k in chunks[0]}
        chunks.clear()
    return out


def rows_of(tables: dict) -> int:
    return sum(next(iter(cols.values())).shape[0]
               for cols in tables.values())


class Q3Mesh:
    """Q3 as a user of the distributed plan writes it: each table is this
    rank's partition (``Table.from_partition``); the orders plan (orders
    joined to the partitioned customer table, filtered) runs first, and
    the lineitem plan joins its sharded result as its build side, then
    groups, orders and limits. The lineitem rows carry only the columns
    the join and the group-by read across the exchange."""

    def __init__(self, rt, tables: dict, mesh, limit: int):
        self.rt, self.mesh, self.limit = rt, mesh, limit
        part = rt.Table.from_partition
        self.customer = part(tables["customer"], mesh)
        self.orders = part(tables["orders"], mesh)
        self.lineitem = part(tables["lineitem"], mesh)
        p = self.param = {}
        self.orders_plan = (
            rt.Query(self.orders)
            .where(lambda t: t["o_orderdate"] < p["date"])
            .join(self.customer, on="custkey", value="c_mktsegment")
            .where(lambda t: t["c_mktsegment"] == p["segment"])
            .with_column("o_datepri", lambda t: t["o_orderdate"] * PACK
                         + t["o_shippriority"]))

    def run(self, segment: int, date: int) -> dict:
        self.param.update(segment=segment, date=date)
        orders, count, _ = self.orders_plan.run(mesh=self.mesh)
        plan = (self.rt.Query(self.lineitem)
                .where(lambda t: t["l_shipdate"] > date)
                .with_column("revenue", lambda t: t["l_extendedprice"]
                             * (100 - t["l_discount"]) // 100)
                .select("orderkey", "revenue")
                .join(orders, on="orderkey", value="o_datepri",
                      build_count=count)
                .groupby_agg(("orderkey", "o_datepri"),
                             {"revenue": ("revenue", "sum")})
                .with_column("neg_datepri", lambda t: -t["o_datepri"])
                .order_by("revenue", "neg_datepri", descending=True)
                .limit(self.limit))
        out, count, _ = plan.run(mesh=self.mesh)
        n = int(count)
        return {"orderkey": out["orderkey"][:n].cpu(),
                "revenue": out["revenue"][:n].cpu(),
                "o_orderdate": (out["o_datepri"][:n] // PACK).cpu(),
                "o_shippriority": (out["o_datepri"][:n] % PACK).cpu()}


# ---------------------------------------------------------------------------
# the world: rank 0 in the harness's process, the others in processes of
# this file
# ---------------------------------------------------------------------------


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _join_world(rank: int, ranks: int, port: int, device_type: str):
    """Join the world; returns the gloo group that carries the orders."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(_backend(device_type),
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=ranks, timeout=timeout)
    return dist.new_group(backend="gloo", timeout=timeout)


def _order(ctl, op: int = STOP, segment: int = 0, date: int = 0):
    """Rank 0 sends an order; the others receive it. Returns it."""
    import torch.distributed as dist

    msg = torch.tensor([op, segment, date], dtype=torch.int64)
    dist.broadcast(msg, src=0, group=ctl)
    return msg.tolist()


def _gather_peaks(ctl, device) -> list:
    """Every rank's allocator peak, on every rank."""
    import torch.distributed as dist

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = [torch.zeros(1, dtype=torch.int64)
           for _ in range(dist.get_world_size())]
    dist.all_gather(out, torch.tensor([peak], dtype=torch.int64), group=ctl)
    return [int(p) for p in out]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Cell:
    def __init__(self, rt, config: dict, mix: dict, *, seed: int, device,
                 reference):
        if mix["query"] != "q3":
            raise ValueError(f"no query {mix['query']!r}")
        self.ref, self.device, self.seed = reference, device, seed
        self.config = config
        self.ranks = int(config["deployment"]["ranks"])
        codes = {name: i for i, name in enumerate(config["segments"])}
        pairs = [(codes[s], d) for s in mix["segments"]
                 for d in range(day(mix["date_first"]),
                                day(mix["date_last"]) + 1)]
        random.Random(seed).shuffle(pairs)
        self.params = pairs
        self.limit = int(mix["limit"])
        self.check_calls = int(mix["check_calls"])
        self.answers: list = []  # (call, params, answer) of every call
        self.rank_peaks: list = []
        self._procs: list = []
        self._ctl = None
        self._ordering = False  # the ranks follow rank 0's orders
        self._released = threading.Event()
        port = _free_port()
        try:
            self._start_ranks(config, seed, port, self.limit)
            self._ctl = _join_world(0, self.ranks, port, device.type)
            mesh = rt.parallel.dsort.make_mesh(self.ranks,
                                               device=device.type)
            self.tables = make_partition(config, seed, 0, self.ranks, device)
            self.query = Q3Mesh(rt, self.tables, mesh, self.limit)
        except BaseException:
            self._stop_ranks()
            raise
        self._ordering = True
        self.rank_rows = rows_of(self.tables)
        # every rank's input rows: the partitions' global row counts
        self.rows = sum(t._global_rows for t in (
            self.query.customer, self.query.orders, self.query.lineitem))
        self.fn = self._run_everywhere
        self.layer = {"rows": self.rows, "rank_rows": self.rank_rows}

    # -- the other ranks ---------------------------------------------------
    def _start_ranks(self, config: dict, seed: int, port: int,
                     limit: int) -> None:
        for rank in range(1, self.ranks):
            arg = json.dumps({"config": config, "seed": seed, "rank": rank,
                              "ranks": self.ranks, "port": port,
                              "limit": limit,
                              "device": self.device.type,
                              "parent": os.getpid()})
            # a rank's output goes to standard error: the harness's
            # standard output ends with the result line
            self._procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), arg],
                cwd=harness.ROOT, stdout=sys.stderr, stdin=subprocess.DEVNULL))
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        """Exit at once when a rank fails before release(): rank 0 would
        otherwise wait in a collective until its time limit."""
        while not self._released.wait(0.2):
            for rank, p in enumerate(self._procs, start=1):
                rc = p.poll()
                if rc is not None and not self._released.is_set():
                    print(f"tpch_mesh: rank {rank} exited with {rc}; "
                          "rank 0 exits", file=sys.stderr, flush=True)
                    os._exit(3)

    def _stop_ranks(self) -> None:
        self._released.set()
        for p in self._procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    # -- the harness's calls ------------------------------------------------
    def _run_everywhere(self, segment: int, date: int) -> dict:
        _order(self._ctl, RUN, segment, date)
        try:
            return self.query.run(segment, date)
        except BaseException:
            self._ordering = False  # the ranks may wait in a collective
            raise

    def use_control(self, name: str) -> None:
        self.fn = lambda seg, date: self.ref.control(
            name, self.tables, seg, date, self.limit)

    def call(self, i: int):
        seg, date = self.params[i % len(self.params)]
        out = self.fn(seg, date)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return (seg, date), out

    def warm(self) -> None:
        for i in range(2):
            out = self.call(i)
            del out

    def keep(self, i: int, out, last: bool) -> None:
        self.answers.append((i,) + out)

    def release(self) -> None:
        """Stop the ranks (each sends its allocator peak first) and free
        this rank's state. Every rank leaves the world at once: NCCL's
        teardown waits for all of them. After a failed call the ranks may
        wait in a collective: they are killed, and the world is left to
        the process's exit."""
        import torch.distributed as dist

        self._released.set()  # the ranks exit now, and not in error
        clean = self._ordering
        if clean:
            _order(self._ctl)
            self.rank_peaks = _gather_peaks(self._ctl, self.device)
            print("tpch_mesh: allocator peak of each rank, bytes: "
                  + json.dumps(self.rank_peaks), file=sys.stderr, flush=True)
            self._ordering = False
            dist.destroy_process_group()
        for p in self._procs:
            try:
                p.wait(timeout=60 if clean else 0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.fn = self.query = self.tables = None

    def check(self) -> dict:
        """The most answer rows any checked call got wrong (limit 0): the
        reference regenerates the tables chunk by chunk on this rank's
        device and answers every checked call in one pass."""
        n = len(self.answers)
        picked = sorted(set(random.Random(self.seed).sample(
            range(n), min(self.check_calls, n))) | {n - 1})
        params = sorted({self.answers[i][1] for i in picked})
        customer = {k: torch.cat([c[k] for c in customer_chunks(
            self.config, self.seed, self.device)]) for k in
            ("custkey", "c_mktsegment")}
        chunks = ((o, li) for o, li, _ in order_chunks(
            self.config, self.seed, self.device))
        want = self.ref.answers(customer, chunks, params, self.limit)
        worst = max(self.ref.mismatched_rows(self.answers[i][2],
                                             want[self.answers[i][1]])
                    for i in picked)
        return {"mismatched_rows": (worst, 0)}


# ---------------------------------------------------------------------------
# a rank other than 0
# ---------------------------------------------------------------------------


def _die_with(parent: int) -> None:
    """Exit when the parent does: the kernel's parent-death signal, and a
    watch on the parent's pid in case the parent died before it was set."""
    import ctypes
    import signal

    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(0.5)

    if os.getppid() != parent:
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def rank_main(arg: dict) -> int:
    _die_with(arg["parent"])
    import port

    rank, ranks = arg["rank"], arg["ranks"]
    if arg["device"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    rt = port.load(harness.ROOT)
    if device.type == "cuda":
        port.build_kernels()
    ctl = _join_world(rank, ranks, arg["port"], device.type)
    mesh = rt.parallel.dsort.make_mesh(ranks, device=device.type)
    config = arg["config"]
    tables = make_partition(config, arg["seed"], rank, ranks, device)
    query = Q3Mesh(rt, tables, mesh, arg["limit"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    while True:
        op, segment, date = _order(ctl)
        if op == STOP:
            break
        query.run(segment, date)
    _gather_peaks(ctl, device)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(json.loads(sys.argv[1])))
