"""The port's public surface as one table of cases, and the card's torch.

Two users import this file: ``tests/test_torch_card_ops.py`` on the CPU
and ``chip_smoke.py``'s ``surface`` and ``card_ops`` phases on the card
(by path, after the port is loaded). It imports torch, numpy and the port,
never JAX.

A ``Case`` names a public function or method (``covers``), builds its
inputs with numpy from a seed (``make``), calls the port (``call``) and
says how a result on the card is compared with the same call on the CPU
(``compare``):

- ``"bits"``: every array bit for bit (floats by their bits, so -0.0,
  NaN signs and payloads count), every Python value equal;
- ``"nan"``: as ``"bits"`` but a float NaN equals any NaN (min, max,
  medians and quantiles: which NaN a min keeps is not fixed, and a NaN
  made by arithmetic has the device's bits);
- ``"close"``: floats within ``atol(inputs)``, integers bit for bit:
  float sums and means within ``F32_TOL`` of the input's sum of |x| (the
  scan kernel folds in another order than its plain version), var within
  ``F32_TOL`` of the largest x^2 and std within its square root
  (``tests/test_torch_aggregate.py::moment_atol``).

Unstable pairs are compared bit for bit: the card runs the same network
or counting pass as the CPU, so equal keys' payloads land in the same
places.

``CARD_UNSIGNED_GAPS`` is what the card's torch refuses on unsigned
tensors, as ``probe_card_ops`` finds it there; ``UnsignedGuard`` raises
on those operators so the CPU tests hold the port to them.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Callable

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# ---------------------------------------------------------------------------
# The card's torch on unsigned tensors.

UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def _probe_ops() -> dict:
    """op name -> fn(a, b, idx, mask) over two unsigned tensors of 64 rows
    (b nonzero), an int64 index tensor and a bool mask. The names are the ones
    ``op_name`` gives the torch functions a call reaches."""
    def setitem(a, key, v):
        c = a.clone()
        c[key] = v
        return c

    return {
        "index": lambda a, b, i, m: a[i],
        "index_mask": lambda a, b, i, m: a[m],
        "index_put": lambda a, b, i, m: setitem(a, i, b[:i.numel()]),
        "index_put_mask": lambda a, b, i, m: setitem(a, m, b[:1]),
        "index_select": lambda a, b, i, m: torch.index_select(a, 0, i),
        "gather": lambda a, b, i, m: torch.gather(a, 0, i),
        "scatter": lambda a, b, i, m: a.clone().scatter_(0, i, b[:i.numel()]),
        "take": lambda a, b, i, m: torch.take(a, i),
        "index_add": lambda a, b, i, m: a.clone().index_add_(0, i, b[:i.numel()]),
        "masked_fill": lambda a, b, i, m: a.masked_fill(m, 0),
        "eq": lambda a, b, i, m: a == b,
        "ne": lambda a, b, i, m: a != b,
        "lt": lambda a, b, i, m: a < b,
        "le": lambda a, b, i, m: a <= b,
        "gt": lambda a, b, i, m: a > b,
        "ge": lambda a, b, i, m: a >= b,
        "maximum": lambda a, b, i, m: torch.maximum(a, b),
        "minimum": lambda a, b, i, m: torch.minimum(a, b),
        "add": lambda a, b, i, m: a + b,
        "sub": lambda a, b, i, m: a - b,
        "mul": lambda a, b, i, m: a * b,
        "remainder": lambda a, b, i, m: a % b,
        "floor_divide": lambda a, b, i, m: a // b,
        "bitwise_and": lambda a, b, i, m: a & b,
        "bitwise_or": lambda a, b, i, m: a | b,
        "bitwise_xor": lambda a, b, i, m: a ^ b,
        "lshift": lambda a, b, i, m: a << 1,
        "rshift": lambda a, b, i, m: a >> 1,
        "where": lambda a, b, i, m: torch.where(m, a, b),
        "sort": lambda a, b, i, m: torch.sort(a),
        "argsort": lambda a, b, i, m: torch.argsort(a),
        "searchsorted": lambda a, b, i, m: torch.searchsorted(a, b),
        "unique": lambda a, b, i, m: torch.unique(a),
        "bincount": lambda a, b, i, m: torch.bincount(a),
        "argmax": lambda a, b, i, m: torch.argmax(a),
        "max": lambda a, b, i, m: a.max(),
        "min": lambda a, b, i, m: a.min(),
        "clamp": lambda a, b, i, m: torch.clamp(a, max=5),
        "cumsum": lambda a, b, i, m: torch.cumsum(a, 0),
        "sum": lambda a, b, i, m: a.sum(),
        "cat": lambda a, b, i, m: torch.cat([a, b]),
        "flip": lambda a, b, i, m: torch.flip(a, [0]),
        "stack": lambda a, b, i, m: torch.stack([a, b]),
        "view": lambda a, b, i, m: a.view(torch.int8),
        "nonzero": lambda a, b, i, m: torch.nonzero(a),
        "roll": lambda a, b, i, m: torch.roll(a, 1),
    }


PROBE_OPS = tuple(_probe_ops())


def probe_card_ops(device: str) -> dict:
    """{op: (dtype names it raised on)} for PROBE_OPS on uint16, uint32 and
    uint64 tensors on ``device``; ops that run on all three are left out.
    Each result is synchronised, so an error raised late still counts."""
    g = np.random.default_rng(7)
    ops = _probe_ops()
    gaps: dict = {}
    for dt in UNSIGNED:
        a = torch.from_numpy(g.integers(0, 50, 64).astype(np.int64)).to(dt).to(device)
        b = torch.from_numpy(g.integers(1, 50, 64).astype(np.int64)).to(dt).to(device)
        i = torch.from_numpy(g.integers(0, 64, 16)).to(device)
        m = torch.from_numpy(g.integers(0, 2, 64).astype(bool)).to(device)
        for name, fn in ops.items():
            try:
                fn(a, b, i, m)
                if device != "cpu":
                    torch.cuda.synchronize()
            except (RuntimeError, TypeError, NotImplementedError):
                gaps.setdefault(name, []).append(str(dt).removeprefix("torch."))
    return {k: tuple(v) for k, v in sorted(gaps.items())}


# What the card's torch refuses on unsigned tensors (NVIDIA H100 80GB HBM3,
# torch 2.11.0+cu128): probe_card_ops("cuda") there. chip_smoke.py's
# card_ops phase fails where the card's answer differs, so this follows the
# card's torch when that changes. Every op is refused on all three dtypes.
_ALL = ("uint16", "uint32", "uint64")
CARD_UNSIGNED_GAPS = {op: _ALL for op in (
    "add", "argmax", "argsort", "bincount", "bitwise_and", "bitwise_or",
    "bitwise_xor", "clamp", "floor_divide", "ge", "gt", "index",
    "index_add", "index_mask", "index_put", "index_put_mask", "le",
    "lshift", "lt", "masked_fill", "max", "maximum", "min", "minimum",
    "mul", "nonzero", "remainder", "roll", "rshift", "searchsorted",
    "sort", "sub", "take", "where")}

# torch function names (as a TorchFunctionMode sees them, dunders and
# trailing underscores stripped) -> the probe's op names: the dunder forms
# and torch's own aliases of the probed ops
_ALIASES = {
    "and": "bitwise_and", "or": "bitwise_or", "xor": "bitwise_xor",
    "mod": "remainder", "floordiv": "floor_divide",
    "bitwise_left_shift": "lshift", "bitwise_right_shift": "rshift",
    "clip": "clamp", "multiply": "mul", "subtract": "sub", "greater": "gt",
    "greater_equal": "ge", "less": "lt", "less_equal": "le",
}


def op_name(func) -> str:
    """The probe's name for a torch function or Tensor method."""
    name = getattr(func, "__name__", "")
    if name.startswith("__") and name.endswith("__"):
        core = name[2:-2]
        if core in ("getitem", "setitem"):
            return core
        if core[:1] in "ir" and core[1:] in (
                "add", "sub", "mul", "mod", "floordiv", "and", "or", "xor",
                "lshift", "rshift", "truediv"):
            core = core[1:]
        name = core
    name = name.rstrip("_")
    return _ALIASES.get(name, name)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _has_tensor(key) -> bool:
    return any(True for _ in _tensors(key))


def _dname(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CardOpError(Exception):
    """An operator the card's torch refuses, reached on an unsigned tensor
    (not a TypeError: torch turns those into NotImplemented in operators)."""


class UnsignedGuard(TorchFunctionMode):
    """Raise ``CardOpError`` on every torch call the card's torch refuses
    (``gaps``: op -> dtype names): a call whose tensor arguments include one
    of those dtypes. Indexing counts only with a tensor in the index
    (``a[i]``, ``a[mask]``, ``a[i] = v``); slices and ints are views the
    card takes. ``hits`` keeps what was refused."""

    def __init__(self, gaps=None):
        super().__init__()
        self.gaps = CARD_UNSIGNED_GAPS if gaps is None else gaps
        self.hits: list = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = op_name(func)
        if name in ("getitem", "setitem"):
            base = args[0] if args else None
            if (isinstance(base, torch.Tensor) and _has_tensor(args[1])):
                key = args[1]
                masked = any(t.dtype == torch.bool for t in _tensors(key))
                name = {("getitem", False): "index",
                        ("getitem", True): "index_mask",
                        ("setitem", False): "index_put",
                        ("setitem", True): "index_put_mask"}[(name, masked)]
                self._check(func, name, [base])
        elif name in self.gaps:
            self._check(func, name, list(_tensors((args, kwargs))))
        return func(*args, **kwargs)

    def _check(self, func, name, tensors) -> None:
        bad = [_dname(t) for t in tensors
               if _dname(t) in self.gaps.get(name, ())]
        if bad:
            self.hits.append((name, bad[0]))
            raise CardOpError(
                f"{getattr(func, '__qualname__', func)} ({name}) on "
                f"{bad[0]}: the card's torch refuses it "
                "(tests/torch_surface.py::CARD_UNSIGNED_GAPS); move the "
                "bits as a signed view (twiddle.signed_view, twiddle.where)")


# ---------------------------------------------------------------------------
# Cases.

F32_TOL = 1e-5  # of the output's largest |value|: sums, means, scans
SEED = 20261017


@dataclasses.dataclass(frozen=True)
class Case:
    """One call of the public surface. ``make(rng, n)`` returns the inputs
    (a tree of CPU tensors); ``call(inputs)`` runs the port on them (the
    same tree on the device under test) and returns a tree of tensors,
    Tables, Python values and tuples. ``needs``: kernels the call must
    launch on the card at each size of ``sizes`` above 1."""
    id: str
    covers: tuple
    make: Callable
    call: Callable
    sizes: tuple
    compare: str = "bits"
    needs: tuple = ()
    atol: Callable | None = None


def tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def _signed(t: torch.Tensor) -> torch.Tensor:
    """The same bits in a signed integer dtype of the same width."""
    if t.dtype == torch.bool:
        return t.to(torch.int8)
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.dtype.itemsize])


def to_host(x):
    """A result tree -> a tree of ("tensor", dtype, device type, bits) and
    plain values, comparable on the host. Tables, DoubleBuffers and other
    objects become dicts of what they hold."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return ("tensor", _dname(t), t.device.type,
                _signed(t.contiguous()).cpu().numpy().copy())
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_host(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if hasattr(x, "column_names"):  # Table
        return {k: to_host(x.column(k)) for k in x.column_names}
    if hasattr(x, "current") and hasattr(x, "alternate"):  # DoubleBuffer
        return {"current": to_host(x.current()),
                "alternate": to_host(x.alternate()),
                "selector": x.selector}
    return {k: to_host(v) for k, v in sorted(vars(x).items())}


def _floats(dtype: str, bits: np.ndarray) -> np.ndarray:
    """Float values (float64) of a float tensor's bits."""
    if dtype == "bfloat16":
        return (bits.astype(np.int32) << 16).view(np.float32).astype(np.float64)
    return bits.view({"float16": np.float16, "float32": np.float32,
                      "float64": np.float64}[dtype]).astype(np.float64)


def _first_diff(path, got, want, mode) -> str | None:
    """The first difference of two ``to_host`` trees, or None."""
    if isinstance(want, tuple) and want[:1] == ("tensor",):
        _, dt, _, w = want
        _, gdt, _, g = got
        if (gdt, g.shape) != (dt, w.shape):
            return f"{path}: {gdt}{list(g.shape)} != {dt}{list(w.shape)}"
        g, w = g.reshape(-1), w.reshape(-1)
        if not dt.startswith(("float", "bfloat")) or mode == "bits":
            bad = np.flatnonzero(g != w)
        else:
            gv, wv = _floats(dt, g), _floats(dt, w)
            both_nan = np.isnan(gv) & np.isnan(wv)
            if mode == "nan":
                bad = np.flatnonzero((g != w) & ~both_nan)
            else:  # ("close", atol)
                same = (gv == wv) | both_nan | (np.abs(gv - wv) <= mode[1])
                bad = np.flatnonzero(~same)
        if bad.size:
            i = int(bad[0])
            return (f"{path}: {bad.size} of {w.size} differ, first at [{i}]:"
                    f" card {g[i]!r} != CPU {w[i]!r} ({dt} bits)")
        return None
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return f"{path}: keys {sorted(got) if isinstance(got, dict) else got!r} != {sorted(want)}"
        for k in want:
            d = _first_diff(f"{path}.{k}", got[k], want[k], mode)
            if d:
                return d
        return None
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return f"{path}: {type(got).__name__} != list of {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            d = _first_diff(f"{path}[{i}]", g, w, mode)
            if d:
                return d
        return None
    if got != want and not (isinstance(want, float) and want != want
                            and got != got):
        return f"{path}: card {got!r} != CPU {want!r}"
    return None


def compare(case: Case, got, want, inputs) -> str | None:
    """The first difference between a card result and a CPU result (both
    ``to_host`` trees) under the case's rule, or None."""
    mode = case.compare
    if mode == "close":
        mode = ("close", case.atol(inputs))
    return _first_diff("out", got, want, mode)


def case_inputs(case: Case, n: int):
    """The case's inputs at size n, made with numpy from a seed of the
    case's id and n (the same on every machine)."""
    seed = [SEED, n] + list(case.id.encode())
    return case.make(np.random.default_rng(seed), n)


def run_case(case: Case, n: int, device: str, inputs=None):
    """The case at size n on ``device``: its result as a ``to_host`` tree."""
    inputs = case_inputs(case, n) if inputs is None else inputs
    args = tree_map(lambda t: t.clone().to(device), inputs)
    return to_host(case.call(args))


def devices_of(tree) -> set:
    """The device types of every tensor in a ``to_host`` tree."""
    if isinstance(tree, tuple) and tree[:1] == ("tensor",):
        return {tree[2]}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return set().union(*(devices_of(v) for v in tree)) if tree else set()
    return set()


# ---------------------------------------------------------------------------
# Inputs.

DT = {"u8": torch.uint8, "u16": torch.uint16, "u32": torch.uint32,
      "u64": torch.uint64, "i8": torch.int8, "i16": torch.int16,
      "i32": torch.int32, "i64": torch.int64, "f16": torch.float16,
      "bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64,
      "bool": torch.bool}
KEY_DTYPES = ("u8", "u16", "u32", "u64", "i8", "i16", "i32", "i64", "f16",
              "bf16", "f32", "f64")
PAYLOAD_DTYPES = ("bool", "i8", "u16", "f16", "bf16", "i32", "u32", "i64",
                  "u64", "f64")
ENGINES = ("auto", "bitonic", "reference")
REFERENCE_MAX = (1 << 16) + 3  # the reference engine runs at <= 2^16 here
# a subnormal of each float width
_SUBNORMAL = {"f16": 3e-6, "bf16": 1e-39, "f32": 1e-39, "f64": 1e-310}


def _tile() -> int:
    from cuda.radixsort_tpu_torch import config

    return config.preset().tile_elems


TILE = _tile()
SIZES = (1, 7, TILE - 1, TILE + 1, (1 << 16) + 3, (1 << 19) + 5)
SMALL = SIZES[:4]
LARGE = SIZES[4:]


def ints(rng, dt: str, n: int, pool: int | None = None) -> torch.Tensor:
    """n integers of dtype ``dt`` over its full range, drawn from ``pool``
    distinct values when given (ties)."""
    b = DT[dt].itemsize * 8
    raw = rng.integers(0, 2**64, size=pool or n, dtype=np.uint64)
    if pool:
        raw = raw[rng.integers(0, pool, size=n)]
    t = torch.from_numpy(raw.astype(f"uint{b}").view(f"int{b}").copy())
    return t.view(DT[dt])


def floats(rng, dt: str, n: int, pool: int | None = None,
           special: bool = True) -> torch.Tensor:
    """n floats of dtype ``dt``; with ``special``, the pool holds +-0.0,
    NaN of both signs, +-inf and +-subnormals, and values repeat."""
    vals = rng.standard_normal(pool or n) * 100
    if special:
        sub = _SUBNORMAL[dt]
        sp = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, sub, -sub, 1.0]
        vals[:len(sp)] = sp[:vals.size]
    if pool:
        vals = vals[rng.integers(0, pool, size=n)]
    else:
        vals = vals[rng.permutation(n)]
    return torch.from_numpy(vals).to(DT[dt])


def keys(rng, dt: str, n: int) -> torch.Tensor:
    """Sort keys of dtype ``dt``, heavy ties (a pool of n/3 values)."""
    pool = n // 3 + 1
    if dt in ("f16", "bf16", "f32", "f64"):
        return floats(rng, dt, n, pool)
    return ints(rng, dt, n, pool)


def payload(rng, dt: str, n: int) -> torch.Tensor:
    if dt == "bool":
        return torch.from_numpy(rng.random(n) < 0.5)
    if dt in ("f16", "bf16", "f32", "f64"):
        return floats(rng, dt, n, special=False)
    return ints(rng, dt, n)


def values(rng, dt: str, n: int, lo: int = -1000, hi: int = 1000):
    """Operator value columns: bounded integers (sums that stay exact) or
    floats of standard deviation 50."""
    if dt in ("f16", "bf16", "f32", "f64"):
        return torch.from_numpy(rng.standard_normal(n) * 50).to(DT[dt])
    v = torch.from_numpy(rng.integers(lo, hi, size=n))
    return v.to(torch.int64).to(torch.int32).view(torch.uint32) \
        if dt == "u32" else v.to(DT[dt])


def group_keys(rng, dt: str, n: int, groups: int | None = None):
    """Keys with about n / 8 distinct values (at least 1) of dtype dt."""
    g = groups or max(1, n // 8)
    if dt in ("f16", "bf16", "f32", "f64"):
        pool = torch.from_numpy(np.round(rng.standard_normal(g) * 1000) / 8)
        pool[:1] = -0.0
        return pool[torch.from_numpy(rng.integers(0, g, size=n))].to(DT[dt])
    return ints(rng, dt, n, g)


def sorted_keys(rng, dt: str, n: int, descending: bool = False):
    """Keys of ``dt`` in the order the port sorts them (CPU, plain)."""
    from cuda.radixsort_tpu_torch.ops.sort import sort

    return sort(keys(rng, dt, n), descending=descending)


def offsets_for(rng, n: int, segments: int | None = None) -> torch.Tensor:
    """(s + 1,) int32 ragged segment offsets over n rows, empty segments
    included."""
    s = segments or max(1, n // 40)
    cuts = np.sort(rng.integers(0, n + 1, size=s - 1))
    return torch.from_numpy(np.concatenate([[0], cuts, [n]]).astype(np.int32))


def heads_for(rng, n: int, p: float = 0.05) -> torch.Tensor:
    return torch.from_numpy(rng.random(n) < p)


def cfg(engine: str = "auto", **kw):
    from cuda.radixsort_tpu_torch.config import SortConfig

    return SortConfig(engine=engine, **kw)


def sum_atol(*xs) -> float:
    """F32_TOL of the inputs' sum of |x|: a float sum's bound, any order."""
    return F32_TOL * max(1.0, sum(float(x.double().abs().sum()) for x in xs))


def sq_atol(x, agg: str) -> float:
    """A variance's bound, F32_TOL of the largest x^2 (E[x^2] - E[x]^2
    cancels), and a standard deviation's, its square root
    (tests/test_torch_aggregate.py::moment_atol)."""
    big = F32_TOL * max(1.0, float(x.double().abs().max()) ** 2 if x.numel() else 1.0)
    return big if agg == "var" else float(np.sqrt(big))


# ---------------------------------------------------------------------------
# The table.

def _rt():
    import cuda.radixsort_tpu_torch as rt

    return rt


def _sort_family() -> list:
    rt = _rt()
    cases = []
    order = ("asc", "desc")
    # large sizes: the radix engine at both, the network at each once
    # (its plain version is slow on a host CPU), the reference at 2^16 + 3
    big = {("u32", "auto", False): LARGE, ("f64", "auto", True): LARGE[:1],
           ("i16", "auto", True): LARGE[1:], ("f32", "bitonic", False): LARGE[:1],
           ("u64", "bitonic", True): LARGE[1:],
           ("bf16", "reference", False): LARGE[:1]}
    for i, dt in enumerate(KEY_DTYPES):
        for e, eng in enumerate(ENGINES):
            for desc in (False, True):
                j = 2 * (i + e) + desc
                sizes = (SMALL[j % 4], SMALL[(j + 1) % 4]) + big.get((dt, eng, desc), ())
                cases.append(Case(
                    f"sort[{dt},{eng},{order[desc]}]", ("ops/sort.py:sort",),
                    lambda rng, n, dt=dt: {"k": keys(rng, dt, n)},
                    lambda a, eng=eng, desc=desc: rt.sort(
                        a["k"], descending=desc, config=cfg(eng)), sizes))
        eng = ENGINES[i % 3]
        cases.append(Case(
            f"argsort[{dt},{eng},{order[i % 2]}]", ("ops/sort.py:argsort",),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n)},
            lambda a, eng=eng, desc=bool(i % 2): rt.argsort(
                a["k"], descending=desc, config=cfg(eng)),
            (SMALL[i % 4], SMALL[(i + 2) % 4])
            + ((LARGE[i % 2],) if eng == "auto" else ())))
        if dt in ("u8", "bf16"):
            continue
        b = DT[dt].itemsize * 8
        lo, hi = (1, 7) if b == 8 else (3, b - 5)
        eng = ENGINES[i % 2]
        cases.append(Case(
            f"sort[{dt},{eng},bits {lo}..{hi}]", ("ops/sort.py:sort",),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n)},
            lambda a, eng=eng, lo=lo, hi=hi, desc=bool(i % 3 == 0): rt.sort(
                a["k"], descending=desc, begin_bit=lo, end_bit=hi,
                config=cfg(eng)), (SMALL[(i + 1) % 4], SMALL[(i + 3) % 4])))
    for i, pdt in enumerate(PAYLOAD_DTYPES):
        kdt = KEY_DTYPES[(3 * i + 1) % len(KEY_DTYPES)]
        eng, stable, desc = ENGINES[i % 3], i % 4 < 2, i % 2 == 1
        sizes = (SMALL[i % 4], SMALL[(i + 1) % 4])
        if eng == "auto":
            sizes += (LARGE[i % 2],)
        cases.append(Case(
            f"sort_pairs[{kdt}+{pdt},{eng},{order[desc]},"
            f"{'stable' if stable else 'unstable'}]", ("ops/sort.py:sort_pairs",),
            lambda rng, n, kdt=kdt, pdt=pdt: {"k": keys(rng, kdt, n),
                                              "v": payload(rng, pdt, n)},
            lambda a, eng=eng, stable=stable, desc=desc: rt.sort_pairs(
                a["k"], a["v"], descending=desc, stable=stable,
                config=cfg(eng)), sizes))
    for eng in ENGINES:
        cases.append(Case(
            f"sort_pairs[i32+{{f32, u64}} and [u64, bf16],{eng}]",
            ("ops/sort.py:sort_pairs",),
            lambda rng, n: {"k": keys(rng, "i32", n),
                            "vd": {"a": payload(rng, "f32", n),
                                   "b": payload(rng, "u64", n)},
                            "vl": [payload(rng, "u64", n), payload(rng, "bf16", n)]},
            lambda a, eng=eng: (rt.sort_pairs(a["k"], a["vd"], config=cfg(eng)),
                                rt.sort_pairs(a["k"], a["vl"], config=cfg(eng),
                                              stable=False)),
            (7, TILE + 1)))
    # the network's split-sort-merge route at small sizes (split at 2^11)
    cases.append(Case(
        "sort_pairs[u32+i32,bitonic split at 2^11,unstable]",
        ("ops/sort.py:sort_pairs",),
        lambda rng, n: {"k": keys(rng, "u32", n), "v": payload(rng, "i32", n)},
        lambda a: (rt.sort(a["k"], config=cfg("bitonic", split_sort_min_logn=11)),
                   rt.sort_pairs(a["k"], a["v"], stable=False,
                                 config=cfg("bitonic", split_sort_min_logn=11))),
        (TILE - 1, TILE + 1)))
    for i, cols in enumerate((("u16", "f32"), ("i64", "bf16", "u8"),
                              ("f64", "i32"))):
        eng = ENGINES[i % 2]
        cases.append(Case(
            f"sort_struct[{'+'.join(cols)},{eng}]", ("ops/sort.py:sort_struct",),
            lambda rng, n, cols=cols: {"k": tuple(keys(rng, c, n) for c in cols),
                                       "v": payload(rng, "i32", n)},
            lambda a, eng=eng, i=i: rt.sort_struct(
                a["k"], a["v"], descending=i == 1, stable=i != 2,
                config=cfg(eng)), SMALL[i:i + 2] + (LARGE[i % 2],)))
    for i, dt in enumerate(("u32", "f32", "i64", "bf16", "u16")):
        eng = ENGINES[i % 2]
        cases.append(Case(
            f"segmented_sort[{dt},{eng}]", ("ops/segmented.py:segmented_sort",),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n),
                                   "o": offsets_for(rng, n),
                                   "v": payload(rng, "u32", n)},
            lambda a, eng=eng, i=i: rt.segmented_sort(
                a["k"], a["o"], a["v"], descending=i % 2 == 1,
                begin_bit=2 if i == 4 else None, end_bit=13 if i == 4 else None,
                config=cfg(eng)), SIZES[i % 3:i % 3 + 3]))
    for i, dt in enumerate(("u32", "i16", "f64", "f32", "u64")):
        eng, desc = ENGINES[i % 3], i % 2 == 1
        sizes = SIZES[i % 4:i % 4 + 2] + ((LARGE[1],) if eng == "auto" else ())
        cases.append(Case(
            f"merge_sorted[{dt},{eng},{order[desc]}]",
            ("ops/merge.py:merge_sorted", "ops/merge.py:merge_sorted_pairs"),
            lambda rng, n, dt=dt, desc=desc: {
                "a": sorted_keys(rng, dt, n, desc),
                "b": sorted_keys(rng, dt, n // 2 + 1, desc),
                "va": payload(rng, "i64", n), "vb": payload(rng, "i64", n // 2 + 1)},
            lambda a, eng=eng, desc=desc: (
                rt.merge_sorted(a["a"], a["b"], descending=desc, config=cfg(eng)),
                rt.merge_sorted_pairs(a["a"], a["va"], a["b"], a["vb"],
                                      descending=desc, config=cfg(eng))),
            sizes))
    for i, dt in enumerate(("u32", "i32", "f32", "u64")):
        for op in ("set_intersection", "set_difference", "set_union",
                   "set_symmetric_difference"):
            cases.append(Case(
                f"{op}[{dt}]", (f"ops/setops.py:{op}",),
                lambda rng, n, dt=dt, i=i: {
                    "a": sorted_keys(rng, dt, n, i == 3),
                    "b": sorted_keys(rng, dt, n // 2 + 1, i == 3)},
                lambda a, op=op, i=i: getattr(rt, op)(
                    a["a"], a["b"], descending=i == 3,
                    config=cfg(ENGINES[i % 2])),
                (SIZES[i], SIZES[i + 2])))
    for i, (dt, msd) in enumerate((("u32", 4), ("f32", 8), ("i32", 6),
                                   ("u64", 4))):
        cases.append(Case(
            f"sort_large[{dt},msd_bits={msd}]", ("ops/sort.py:sort_large",),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n)},
            lambda a, msd=msd, i=i: rt.sort_large(a["k"], descending=i == 1,
                                                  msd_bits=msd),
            (SMALL[i], TILE + 1, LARGE[i % 2])))
    return cases


COLUMN_DTYPES = ("u32", "i32", "f32")
# the sizes each column dtype runs at: the three cover SIZES
SPREAD = {"u32": (SIZES[0], SIZES[3]), "i32": (SIZES[1], SIZES[4]),
          "f32": (SIZES[2], SIZES[5])}


def _join_data(rng, dt, n, valid=False):
    nb = n // 4 + 1
    bk = keys(rng, dt, nb)
    other = keys(rng, dt, n)
    pick = torch.from_numpy(rng.integers(0, nb, size=n))
    pk = torch.where(torch.from_numpy(rng.random(n) < 0.7),
                     _signed(bk)[pick], _signed(other)).view(DT[dt])
    out = {"bk": bk, "bv": values(rng, "i32", nb), "pk": pk}
    if valid:
        out["bvalid"] = torch.from_numpy(rng.random(nb) < 0.8)
        out["pvalid"] = torch.from_numpy(rng.random(n) < 0.8)
    return out


def _operators() -> list:
    import importlib

    rt = _rt()
    scan_ops = importlib.import_module("cuda.radixsort_tpu_torch.ops.scan")
    hist_ops = importlib.import_module("cuda.radixsort_tpu_torch.ops.histogram")
    cases = []
    hows = ("inner", "left", "right", "full", "semi", "anti")
    for h, how in enumerate(hows):
        for dt in COLUMN_DTYPES:
            masked = h % 2 == 0 and dt == "i32"
            cases.append(Case(
                f"join[{how},{dt}{',valid' if masked else ''}]",
                ("ops/join.py:join",),
                lambda rng, n, dt=dt, masked=masked: _join_data(rng, dt, n, masked),
                lambda a, how=how: rt.join(
                    a["bk"], a["bv"], a["pk"], how=how,
                    build_valid=a.get("bvalid"), probe_valid=a.get("pvalid")),
                SPREAD[dt]))
    for dt in COLUMN_DTYPES:
        cases.append(Case(
            f"join_count+join_expand[{dt}]",
            ("ops/join.py:join_count", "ops/join.py:join_expand"),
            lambda rng, n, dt=dt: _join_data(rng, dt, n),
            lambda a, dt=dt: (
                rt.join_count(a["bk"], a["pk"]),
                rt.join_expand(a["bk"], a["bv"], a["pk"],
                               capacity=int(rt.join_count(a["bk"], a["pk"])) + 3,
                               how="left" if dt == "i32" else "inner")),
            SPREAD[dt]))
        cases.append(Case(
            f"join[composite (u16, {dt})]", ("ops/join.py:join",),
            lambda rng, n, dt=dt: {
                "bk": (group_keys(rng, "u16", n // 4 + 1, 5), keys(rng, dt, n // 4 + 1)),
                "bv": values(rng, "i32", n // 4 + 1),
                "pk": (group_keys(rng, "u16", n, 5), keys(rng, dt, n))},
            lambda a: rt.join(a["bk"], a["bv"], a["pk"]), SPREAD[dt][:1]))
    aggs = ("sum", "count", "min", "max", "mean", "var", "std", "median")
    for g, agg in enumerate(aggs):
        for masked in (False, True):
            kdt = COLUMN_DTYPES[(g + masked) % 3]
            vdt = "i32" if agg in ("sum", "count", "min", "max") and masked else "f32"
            # NaN (the rows past count of a median) by value: its bits
            # are the device's own
            mode, tol = ("nan" if agg == "median" else "bits"), None
            if vdt == "f32" and agg in ("sum", "mean"):
                mode, tol = "close", (lambda a: sum_atol(a["v"]))
            elif agg in ("var", "std"):
                mode, tol = "close", (lambda a, agg=agg: sq_atol(a["v"], agg))
            elif vdt == "f32" and agg in ("min", "max"):
                mode = "nan"
            cases.append(Case(
                f"groupby[{agg},{kdt} keys,{vdt}{',valid' if masked else ''}]",
                ("ops/aggregate.py:groupby",),
                lambda rng, n, kdt=kdt, vdt=vdt, masked=masked: dict(
                    k=group_keys(rng, kdt, n), v=values(rng, vdt, n),
                    **({"m": heads_for(rng, n, 0.7)} if masked else {})),
                lambda a, agg=agg: rt.groupby(a["k"], a["v"], agg=agg,
                                              valid=a.get("m")),
                SPREAD[COLUMN_DTYPES[(g + masked + 1) % 3]], mode, atol=tol))
    for i, dt in enumerate(COLUMN_DTYPES):
        cases.append(Case(
            f"groupby_multi[({dt}, i64),valid={i == 1}]",
            ("ops/aggregate.py:groupby_multi",),
            lambda rng, n, dt=dt: {
                "k": (group_keys(rng, dt, n, 7), group_keys(rng, "i64", n, 5)),
                "v": (values(rng, "i32", n), values(rng, "i32", n),
                      values(rng, "i32", n), values(rng, "f32", n)),
                "m": heads_for(rng, n, 0.6)},
            lambda a, i=i: rt.groupby_multi(a["k"], a["v"],
                                            ("sum", "count", "max", "mean"),
                                            valid=a["m"] if i == 1 else None),
            SPREAD[dt], "close", atol=lambda a: sum_atol(a["v"][3])))
        cases.append(Case(
            f"groupby_quantile[{dt} keys]", ("ops/aggregate.py:groupby_quantile",),
            lambda rng, n, dt=dt, i=i: {"k": group_keys(rng, dt, n),
                                        "v": values(rng, COLUMN_DTYPES[(i + 2) % 3], n),
                                   "m": heads_for(rng, n, 0.8)},
            lambda a, i=i: rt.groupby_quantile(
                a["k"], a["v"], (0.0, 0.25, 0.5, 0.9, 1.0),
                valid=a["m"] if i != 1 else None), SPREAD[dt], "nan"))
    for o, op in enumerate(("sum", "min", "max", "prod")):
        for e, engine in enumerate(scan_ops.ENGINES):
            if op == "prod" and engine == "pallas":
                continue  # the scan kernel takes sum, min and max
            dt = "i32" if op == "prod" else COLUMN_DTYPES[(o + e) % 3]
            excl, init = (o + e) % 2 == 1, (3 if e == 2 else None)
            if op == "prod":
                init = None if e else 2
            mode, tol = "bits", None
            if dt == "f32":
                mode, tol = ("close", lambda a: sum_atol(a["v"]) + 3) \
                    if op == "sum" else ("nan", None)
            cases.append(Case(
                f"segmented_scan[{op},{engine},{dt},"
                f"{'exclusive' if excl else 'inclusive'},init={init}]",
                ("ops/scan.py:segmented_scan",),
                lambda rng, n, dt=dt: {"v": values(rng, dt, n, -3, 4),
                                       "h": heads_for(rng, n)},
                lambda a, op=op, engine=engine, excl=excl, init=init: (
                    rt.segmented_scan(a["v"], a["h"], op, exclusive=excl,
                                      init=init, engine=engine)),
                SPREAD[COLUMN_DTYPES[(o + e + 1) % 3]], mode, atol=tol))
            if e == 0 or op == "sum":
                kdt = COLUMN_DTYPES[(o + e + 2) % 3]
                cases.append(Case(
                    f"scan_by_key[{op},{engine},{kdt} keys,{dt}]",
                    ("ops/scan.py:scan_by_key",),
                    lambda rng, n, dt=dt, kdt=kdt: {
                        "k": rt.sort(group_keys(rng, kdt, n)),
                        "v": values(rng, dt, n, -3, 4)},
                    lambda a, op=op, engine=engine, excl=excl: rt.scan_by_key(
                        a["k"], a["v"], op, exclusive=not excl,
                        init=1 if op == "sum" else None, engine=engine),
                    SPREAD[kdt], mode, atol=tol))
    for i, dt in enumerate(COLUMN_DTYPES):
        cases.append(Case(
            f"reduce_with+plain_scan+plain_scan_fast[{dt}]",
            ("ops/scan.py:reduce_with", "ops/scan.py:plain_scan",
             "ops/scan.py:plain_scan_fast"),
            lambda rng, n, dt=dt: {"v": values(rng, dt, n, -3, 4)},
            lambda a: (scan_ops.reduce_with(a["v"], "max"),
                       scan_ops.reduce_with(a["v"], "sum", 5),
                       scan_ops.plain_scan(a["v"], "min", exclusive=True),
                       scan_ops.plain_scan_fast(a["v"], "max")),
            SPREAD[dt], "close" if dt == "f32" else "bits",
            atol=lambda a: sum_atol(a["v"]) + 5))
        cases.append(Case(
            f"filter_columns+selection_vector[{dt}]",
            ("ops/filter.py:filter_columns", "ops/filter.py:selection_vector"),
            lambda rng, n, dt=dt: {"m": heads_for(rng, n, 0.4),
                                   "c": {"a": keys(rng, dt, n),
                                         "b": payload(rng, "u64", n)}},
            lambda a: (rt.filter_columns(a["m"], a["c"]),
                       rt.filter_columns(a["m"], a["c"]["a"]),
                       rt.selection_vector(a["m"])), SPREAD[dt]))
        bits = (4, 8, 2)[i]
        cases.append(Case(
            f"partition+bucket_ids+hash32[{dt},bits={bits}]",
            ("ops/partition.py:partition", "ops/partition.py:bucket_ids",
             "ops/partition.py:hash32"),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n),
                                   "v": payload(rng, "f64", n)},
            lambda a, bits=bits, i=i: (
                rt.partition(a["k"], a["v"], bits=bits),
                rt.partition(a["k"], [a["v"]] if i else None, bits=bits,
                             by_hash=True),
                rt.bucket_ids(a["k"], bits=bits),
                rt.bucket_ids(a["k"], bits=bits, by_hash=True),
                rt.hash32(a["k"])), SPREAD[dt]))
        cases.append(Case(
            f"unique+run_length_encode+non_trivial_runs+distinct[{dt}]",
            ("ops/unique.py:unique", "ops/unique.py:run_length_encode",
             "ops/unique.py:non_trivial_runs", "ops/unique.py:distinct"),
            lambda rng, n, dt=dt: {"s": rt.sort(group_keys(rng, dt, n)),
                                   "k": group_keys(rng, dt, n)},
            lambda a: (rt.unique(a["s"]), rt.run_length_encode(a["s"]),
                       rt.non_trivial_runs(a["s"]), rt.distinct(a["k"])),
            SPREAD[dt]))
    for i, dt in enumerate(KEY_DTYPES):
        cases.append(Case(
            f"kth_value+top_k[{dt}]", ("ops/select.py:kth_value",
                                       "ops/select.py:top_k"),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n)},
            lambda a, i=i: (
                rt.kth_value(a["k"], 0), rt.kth_value(a["k"], a["k"].shape[0] // 2,
                                                      largest=True),
                rt.kth_value(a["k"], torch.tensor(a["k"].shape[0] - 1,
                                                  device=a["k"].device)),
                rt.top_k(a["k"], min(a["k"].shape[0], 5 + i),
                         largest=i % 2 == 0, sorted_result=i % 3 != 0)),
            SPREAD[COLUMN_DTYPES[i % 3]]))
    for i, dt in enumerate(COLUMN_DTYPES + ("u8", "i64")):
        cases.append(Case(
            f"histogram_even+histogram_range+digit_histogram[{dt}]",
            ("ops/histogram.py:histogram_even", "ops/histogram.py:histogram_range",
             "ops/histogram.py:digit_histogram", "ops/histogram.py:count_bins"),
            lambda rng, n, dt=dt: {"s": values(rng, "f32" if dt == "f32" else "i32",
                                               n, -1000, 1000),
                                   "k": keys(rng, dt, n),
                                   "lv": torch.tensor([-900.0, -10.0, 0.0, 3.5, 500.0]),
                                   "b": torch.from_numpy(rng.integers(0, 40, n + 1))},
            lambda a, i=i: (
                rt.histogram_even(a["s"], 37, -800, 900),
                rt.histogram_range(a["s"].float(), a["lv"]),
                rt.digit_histogram(a["k"], begin_bit=(0, 3, 4, 1, 60)[i],
                                   bits=(8, 4, 2, 5, 3)[i]),
                hist_ops.count_bins(a["b"].clamp(max=39), 40)),
            SPREAD[COLUMN_DTYPES[i % 3]]))
    return cases


def _by_score(a, b):  # score descending, then id ascending
    return (a["score"] > b["score"]) | ((a["score"] == b["score"])
                                        & (a["id"] < b["id"]))


def _compat_data(rng, n):
    """The compat cases' inputs: u32 keys with ties, i32 and f32 values,
    sorted i32 runs, flags, ragged offsets and a record of two fields."""
    return {"u": keys(rng, "u32", n), "i": values(rng, "i32", n),
            "f": values(rng, "f32", n),
            "s": torch.sort(values(rng, "i32", n, 0, max(2, n // 8)))[0],
            "fl": heads_for(rng, n, 0.4), "o": offsets_for(rng, n, 7),
            "rec": {"score": values(rng, "i32", n, 0, 4).float(),
                    "id": values(rng, "i32", n, 0, 3)},
            "px": values(rng, "i32", 4 * n, 0, 256).reshape(n, 4),
            "lv": torch.tensor([0.0, -30.0, -1.0, 0.5, 20.0, 90.0]).sort()[0],
            "ilv": torch.tensor([0, 10, 100, 200, 256], dtype=torch.int32),
            "dst": torch.zeros(n + 20, dtype=torch.int32)}


def _cub_cases() -> list:
    from cuda.radixsort_tpu_torch import cub_compat as cub
    from cuda.radixsort_tpu_torch.ops.comparator_sort import greater

    C = "cub_compat.py:"
    f32 = lambda a: sum_atol(a["f"]) + 8  # noqa: E731
    out = []

    def add(name, covers, call, sizes=(7, TILE + 1), mode="bits", atol=f32):
        out.append(Case(f"cub.{name}", tuple(C + c for c in covers),
                        _compat_data, call, sizes, mode, atol=atol))

    rs = cub.DeviceRadixSort
    add("DeviceRadixSort", ["DeviceRadixSort.SortKeys",
                            "DeviceRadixSort.SortKeysDescending",
                            "DeviceRadixSort.SortPairs",
                            "DeviceRadixSort.SortPairsDescending",
                            "DoubleBuffer", "DoubleBuffer.current",
                            "DoubleBuffer.alternate"],
        lambda a: (rs.SortKeys(a["u"]), rs.SortKeysDescending(a["u"], None, 4, 20),
                   rs.SortPairs(a["u"], a["f"], None, 3, 29),
                   rs.SortPairsDescending(a["f"], a["i"]),
                   rs.SortKeys((a["i"], a["f"]), decomposer=lambda kv: kv),
                   rs.SortPairs(cub.DoubleBuffer(a["u"]), cub.DoubleBuffer(a["i"]))),
        (7, TILE + 1, LARGE[0]))
    for cls in ("DeviceSegmentedRadixSort", "DeviceSegmentedSort"):
        c = getattr(cub, cls)
        names = [m for m in vars(c) if m[:1] != "_"]
        add(cls, [f"{cls}.{m}" for m in names],
            lambda a, c=c, names=names: [
                getattr(c, m)(*((a["u"], a["i"]) if "Pairs" in m else (a["u"],)),
                              None, 7, a["o"][:-1], a["o"][1:] if j % 2 else None)
                for j, m in enumerate(names)])
    sel, part = cub.DeviceSelect, cub.DevicePartition
    add("DeviceSelect+DevicePartition",
        ["DeviceSelect.Flagged", "DeviceSelect.If", "DeviceSelect.FlaggedIf",
         "DeviceSelect.Unique", "DeviceSelect.UniqueByKey",
         "DevicePartition.Flagged", "DevicePartition.If",
         "DevicePartition.ThreeWay"],
        lambda a: (sel.Flagged(a["u"], a["fl"]), sel.If(a["i"], lambda x: x % 3 == 1),
                   sel.FlaggedIf(a["u"], a["fl"], lambda f: ~f),
                   sel.Unique(a["s"]), sel.UniqueByKey(a["s"], a["f"]),
                   part.Flagged(a["u"], a["fl"]), part.If(a["i"], lambda x: x > 2),
                   part.ThreeWay(a["s"], lambda x: x % 3 == 0, lambda x: x < 10),
                   part.ThreeWay({"k": a["s"], "w": a["f"]},
                                 lambda d: d["w"] > 0.5,
                                 lambda d: d["k"] % 2 == 0)))
    rle = cub.DeviceRunLengthEncode
    add("DeviceRunLengthEncode", ["DeviceRunLengthEncode.Encode",
                                  "DeviceRunLengthEncode.NonTrivialRuns"],
        lambda a: (rle.Encode(a["s"]), rle.NonTrivialRuns(a["s"]),
                   rle.Encode(torch.sort(a["u"].view(torch.int32))[0].view(torch.uint32))))
    h = cub.DeviceHistogram
    add("DeviceHistogram", ["DeviceHistogram.HistogramEven",
                            "DeviceHistogram.HistogramRange",
                            "DeviceHistogram.MultiHistogramEven",
                            "DeviceHistogram.MultiHistogramRange"],
        lambda a: (h.HistogramEven(a["f"], 11, -50.0, 50.0),
                   h.HistogramRange(a["f"], 6, a["lv"]),
                   h.MultiHistogramEven(a["px"], [257, 17, 9, 5], 0, 256,
                                        num_active_channels=3),
                   h.MultiHistogramRange(a["px"], [5, 5], [a["ilv"], a["ilv"]],
                                         num_active_channels=2)))
    m = cub.DeviceMerge
    add("DeviceMerge", ["DeviceMerge.MergeKeys", "DeviceMerge.MergePairs"],
        lambda a: (m.MergeKeys(a["s"], a["s"][: a["s"].shape[0] // 2]),
                   m.MergePairs(a["s"], a["u"], a["s"], a["f"]),
                   m.MergeKeys(a["s"].flip(0), a["s"].flip(0), descending=True)))
    sc = cub.DeviceScan
    add("DeviceScan", [f"DeviceScan.{x}" for x in vars(sc) if x[:1] != "_"],
        lambda a: (sc.ExclusiveSum(a["f"]), sc.InclusiveSum(a["i"]),
                   sc.InclusiveSum(a["u"]),
                   sc.ExclusiveScan(a["i"], torch.maximum, 5),
                   sc.InclusiveScan(a["f"], torch.minimum),
                   sc.InclusiveScanInit(a["i"], torch.maximum, -7),
                   sc.InclusiveSumByKey(a["s"], a["i"]),
                   sc.ExclusiveSumByKey(a["s"], a["f"]),
                   sc.InclusiveScanByKey(a["s"], a["i"], "max"),
                   sc.ExclusiveScanByKey(a["s"], a["i"], "prod", 3),
                   sc.ExclusiveScanByKey(a["s"], a["i"], torch.maximum, 3,
                                         identity=-2**31),
                   sc.InclusiveSumByKey(a["s"], a["i"],
                                        equality_op=lambda x, y: (x // 3) == (y // 3))),
        mode="close", atol=lambda a: sum_atol(a["f"]) * 2 + 8)
    r = cub.DeviceReduce
    add("DeviceReduce", [f"DeviceReduce.{x}" for x in vars(r) if x[:1] != "_"],
        lambda a: (r.Sum(a["f"]), r.Sum(a["u"]), r.Min(a["u"]), r.Max(a["f"]),
                   r.ArgMin(a["i"]), r.ArgMax(a["u"]),
                   r.Reduce(a["i"], torch.maximum, 0),
                   r.TransformReduce(a["i"], torch.minimum, lambda x: x * 3, 0),
                   r.ReduceByKey(a["s"], a["i"], "max"),
                   r.ReduceByKey(a["s"], a["f"])),
        mode="close")
    sr = cub.DeviceSegmentedReduce
    add("DeviceSegmentedReduce", ["DeviceSegmentedReduce.Sum",
                                  "DeviceSegmentedReduce.Min",
                                  "DeviceSegmentedReduce.Max"],
        lambda a: (sr.Sum(a["f"], None, a["o"]), sr.Min(a["u"], None, a["o"]),
                   sr.Max(a["i"], None, a["o"][:-1], a["o"][1:])),
        mode="close")
    ad = cub.DeviceAdjacentDifference
    add("DeviceAdjacentDifference",
        [f"DeviceAdjacentDifference.{x}" for x in vars(ad) if x[:1] != "_"],
        lambda a: (ad.SubtractLeftCopy(a["u"]), ad.SubtractRightCopy(a["i"]),
                   ad.SubtractLeft(a["f"]), ad.SubtractRight(a["u"]),
                   ad.SubtractLeftCopy(a["i"], difference_op=lambda x, y: x * 2 - y)))
    tk = cub.DeviceTopK
    add("DeviceTopK", [f"DeviceTopK.{x}" for x in vars(tk) if x[:1] != "_"],
        lambda a: (tk.MaxKeys(a["u"], min(5, a["u"].shape[0])),
                   tk.MinKeys(a["f"], a["f"].shape[0] // 2 + 1),
                   tk.MaxPairs(a["i"], a["u"], 3), tk.MinPairs(a["u"], a["i"], 7)),
        (7, TILE - 1, LARGE[1]))
    add("DeviceTransform", ["DeviceTransform.Transform"],
        lambda a: (cub.DeviceTransform.Transform((a["i"], a["i"].flip(0)),
                                                 lambda x, y: x ^ y),
                   cub.DeviceTransform.Transform(a["i"], lambda x: x // 3)))
    ms = cub.DeviceMergeSort
    add("DeviceMergeSort", [f"DeviceMergeSort.{x}" for x in vars(ms) if x[:1] != "_"],
        lambda a: (ms.SortKeys(a["u"]), ms.StableSortKeys(a["i"], None, lambda x, y: (x % 7) < (y % 7)),
                   ms.SortKeysCopy(a["f"]), ms.StableSortKeysCopy(a["u"], None, greater),
                   ms.SortPairs(a["i"], a["f"]),
                   ms.StableSortPairs(a["rec"], a["i"], None, _by_score)))
    for cls in ("DeviceCopy", "DeviceMemcpy"):
        add(cls, [f"{cls}.Batched"],
            lambda a, cls=cls: getattr(cub, cls).Batched(
                a["i"], a["dst"], [0, 1, 3], [5, 0, 2], [1, 2, 3], 3), (7,))
    fo = cub.DeviceFor
    add("DeviceFor", [f"DeviceFor.{x}" for x in vars(fo) if x[:1] != "_"],
        lambda a: (fo.Bulk(10, lambda i: i * i, device=a["i"].device),
                   fo.ForEach(a["i"], lambda x: x * 2 + 1),
                   fo.ForEachCopy(a["f"], lambda x: x * 2),
                   fo.ForEachN(a["i"], min(5, a["i"].shape[0]), lambda x: -x),
                   fo.ForEachCopyN(a["i"], 1, lambda x: -x),
                   fo.ForEachInExtents((3, 4), lambda i, j: i * 10 + j,
                                       device=a["i"].device)))
    return out


def _thrust_cases() -> list:
    from cuda.radixsort_tpu_torch import thrust_compat as th

    T = "thrust_compat.py:"
    out = []

    def add(name, covers, call, sizes=(7, TILE + 1), mode="bits", atol=None):
        out.append(Case(f"thrust.{name}", tuple(T + c for c in covers),
                        _compat_data, call, sizes, mode,
                        atol=atol or (lambda a: sum_atol(a["f"]) * 2 + 8)))

    add("sorts", ["sort", "stable_sort", "sort_by_key", "stable_sort_by_key",
                  "is_sorted", "is_sorted_until"],
        lambda a: (th.sort(a["u"]), th.stable_sort(a["f"], th.greater),
                   th.sort_by_key(a["i"], a["f"]),
                   th.stable_sort_by_key(a["u"], a["px"].float()),
                   th.stable_sort(a["i"], lambda x, y: (x % 7) < (y % 7)),
                   th.is_sorted(a["s"]), th.is_sorted(a["u"]),
                   th.is_sorted_until(a["i"]), th.is_sorted_until(a["s"], th.greater)),
        (7, TILE + 1, LARGE[0]))
    add("merges and sets", ["merge", "merge_by_key", "set_intersection",
                            "set_union", "set_difference",
                            "set_symmetric_difference"],
        lambda a: (th.merge(a["s"], a["s"][::2]),
                   th.merge_by_key(a["s"].flip(0), a["i"], a["s"].flip(0), a["f"],
                                   th.greater),
                   th.set_intersection(a["s"], a["s"][1::3]),
                   th.set_union(a["s"], a["s"][1::3]),
                   th.set_difference(a["s"], a["s"][1::3]),
                   th.set_symmetric_difference(a["s"][::2], a["s"][1::3])))
    pred = lambda x: x % 3 == 1  # noqa: E731
    add("unique and partitions", ["unique", "unique_by_key", "unique_count",
                                  "copy_if", "remove_if", "stable_partition",
                                  "partition", "partition_copy",
                                  "partition_point"],
        lambda a: (th.unique(a["s"]), th.unique_by_key(a["s"], a["f"]),
                   th.unique_count(a["s"]), th.copy_if(a["i"], pred),
                   th.remove_if(a["i"], pred), th.stable_partition(a["i"], pred),
                   th.partition(a["i"], pred), th.partition_copy(a["i"], pred),
                   th.partition_point(th.stable_partition(a["i"], pred)[0], pred)))
    add("reductions and scans", ["reduce", "reduce_by_key", "inclusive_scan",
                                 "exclusive_scan", "inclusive_scan_by_key",
                                 "exclusive_scan_by_key", "transform_reduce",
                                 "transform_inclusive_scan",
                                 "transform_exclusive_scan", "inner_product"],
        lambda a: (th.reduce(a["f"]), th.reduce(a["u"], 3),
                   th.reduce(a["i"], 0, torch.maximum),
                   th.reduce_by_key(a["s"], a["i"]),
                   th.reduce_by_key(a["s"], a["f"], "max"),
                   th.inclusive_scan(a["f"]), th.inclusive_scan(a["i"], torch.maximum),
                   th.exclusive_scan(a["u"], 3), th.exclusive_scan(a["i"], -5, torch.minimum),
                   th.inclusive_scan_by_key(a["s"], a["i"]),
                   th.exclusive_scan_by_key(a["s"], a["f"], 1.5),
                   th.transform_reduce(a["i"], lambda x: x * 2, 0, torch.maximum),
                   th.transform_inclusive_scan(a["i"], lambda x: -x, torch.minimum),
                   th.transform_exclusive_scan(a["i"], lambda x: x % 5, 0, torch.maximum),
                   th.inner_product(a["i"], a["i"].flip(0), 3)),
        mode="close", atol=lambda a: sum_atol(a["f"]) * 2 + 8)
    add("searches and counts", ["count", "count_if", "min_element",
                                "max_element", "lower_bound", "upper_bound",
                                "binary_search", "all_of", "any_of",
                                "none_of", "find", "find_if", "mismatch",
                                "equal"],
        lambda a: (th.count(a["u"], a["u"][0]), th.count_if(a["i"], lambda x: x > 0),
                   th.min_element(a["u"]), th.max_element(a["f"], th.greater),
                   th.max_element(a["i"], lambda x, y: (x % 7) < (y % 7)),
                   th.lower_bound(a["s"], a["i"]), th.upper_bound(a["s"], a["s"][::3]),
                   th.binary_search(a["s"], a["i"]),
                   th.all_of(a["i"], lambda x: x > -50), th.any_of(a["i"], pred),
                   th.none_of(a["i"], pred), th.find(a["u"], a["u"][-1]),
                   th.find_if(a["i"], lambda x: x > 100),
                   th.mismatch(a["i"], a["i"].flip(0)), th.equal(a["u"], a["u"])))
    add("transforms and copies", ["gather", "scatter", "sequence", "for_each",
                                  "transform", "tabulate", "fill", "replace",
                                  "replace_if", "adjacent_difference",
                                  "reverse", "swap_ranges"],
        lambda a: (th.gather(torch.arange(a["u"].shape[0], device=a["u"].device).flip(0),
                             a["u"]),
                   th.scatter(a["i"], torch.arange(a["i"].shape[0], device=a["i"].device).flip(0),
                              a["i"].shape[0] + 2),
                   th.sequence(9, 3, 2, device=a["i"].device),
                   th.for_each(a["i"], lambda x: x * 3),
                   th.transform(lambda x, y: x - y, a["i"], a["i"].flip(0)),
                   th.tabulate(6, lambda i: i * i, device=a["i"].device),
                   th.fill(a["u"], 9), th.replace(a["u"], a["u"][0], 7),
                   th.replace_if(a["i"], lambda x: x < 0, 0),
                   th.adjacent_difference(a["u"]),
                   th.adjacent_difference(a["i"], lambda x, y: x * 2 - y),
                   th.reverse(a["f"]), th.swap_ranges(a["u"], th.reverse(a["u"]))))
    return out


def _orders(rng, n):
    """P4's tables at n orders: k uniform below n / 2, v in [-1000, 1000),
    f floats; parts: the even keys below n / 2 with a price each."""
    nb = max(1, n // 4)
    return {"o": {"k": ints(rng, "u32", n) if n < 4 else
                  torch.from_numpy(rng.integers(0, 2 * nb, n)).to(torch.int32).view(torch.uint32),
                  "v": values(rng, "i32", n), "f": values(rng, "f32", n),
                  "g": values(rng, "i32", n, 0, 3)},
            "p": {"k": (torch.arange(nb, dtype=torch.int32) * 2).view(torch.uint32),
                  "price": values(rng, "i32", nb, 1, 1000),
                  "g": values(rng, "i32", nb, 0, 3)}}


def _tables(a):
    rt = _rt()
    return rt.Table(a["o"]), rt.table(**a["p"])


def _query_layer() -> list:
    import importlib

    rt = _rt()
    tbl_mod = importlib.import_module("cuda.radixsort_tpu_torch.table")
    Q = rt.Query
    P4 = (1 << 16,)
    out = []
    plans = (  # (name, the Query methods it calls besides run and explain, plan)
        ("readme", ("where", "join", "groupby", "order_by", "limit"),
         lambda o, p: (Q(o).where(lambda t: t["v"] > 100)
                       .join(p, on="k", value="price")
                       .groupby("k", "v", agg="sum")
                       .order_by("v", descending=True).limit(10))),
        ("window_groupby_agg", ("where", "join", "window", "groupby_agg"),
         lambda o, p: (Q(o).where(lambda t: t["v"] > 100)
                       .join(p, on="k", value="price")
                       .window("k", "v", {"rn": "row_number", "cs": ("v", "cumsum")})
                       .groupby_agg(["k"], {"s": ("v", "sum"), "mu": ("v", "mean"),
                                            "med": ("v", "median"), "n": ("rn", "max"),
                                            "top": ("cs", "max")}))),
        ("distinct", ("where", "distinct"),
         lambda o, p: Q(o).where(lambda t: t["v"] > 100).distinct("k")),
        ("select_quantiles", ("select", "with_column", "where", "quantiles"),
         lambda o, p: (Q(o).select("k", "v", "f")
                       .with_column("w", lambda t: t["v"] * 3)
                       .where(lambda t: t["w"] > 0).quantiles("k", "f", (0.25, 0.5)))),
        ("full_window_order_by", ("join", "window", "order_by"),
         lambda o, p: (Q(o).join(p, on="k", value="price", how="full")
                       .window("k", "v", {"r": "rank", "dr": "dense_rank",
                                          "lg": ("v", "lag")}, descending=True)
                       .order_by("k", "r"))),
        ("semi_groupby_limit", ("join", "groupby", "limit"),
         lambda o, p: (Q(o).join(p, on=("k", "g"), how="semi")
                       .groupby("g", "f", agg="std").limit(3))),
    )
    for name, methods, plan in plans:
        out.append(Case(
            f"Query[{name}]",
            ("pipeline/plan.py:Query",) + tuple(
                f"pipeline/plan.py:Query.{m}" for m in methods + ("run", "explain")),
            _orders,
            lambda a, plan=plan: (lambda q: (q.explain(), q.run(),
                                             q.run(timed=True)[:-1]))(
                plan(*_tables(a))),
            (7, TILE + 1) + P4, "close",
            atol=lambda a: 1e-3 * max(1.0, float(a["o"]["f"].abs().max()))))
    tbl = "table.py:Table."
    out.append(Case(
        "Table methods", ("table.py:Table", "table.py:table") + tuple(
            tbl + m for m in ("num_rows", "column_names", "device", "column", "select", "with_column", "sort_by",
                              "sort_by_columns", "filter", "partition_by",
                              "groupby", "groupby_agg", "distinct", "window",
                              "join")),
        _orders,
        lambda a: (lambda o, p: (
            o.num_rows, o.column_names, o.device == a["o"]["v"].device,
            o.column("v"), o.select(["k", "f"]), o.with_column("z", o.column("g")),
            o.sort_by("f", descending=True), o.sort_by_columns(["g", "k"]),
            o.filter(o.column("v") > 0), o.partition_by("k", bits=4),
            o.partition_by("v", bits=3, by_hash=True),
            o.groupby("k", "v", agg="max"),
            o.groupby_agg(["g"], {"s": ("v", "sum"), "m": ("f", "max")}),
            o.distinct("g", "k"),
            o.window("g", "v", {"rn": "row_number", "cm": ("f", "cummin")}),
            o.join(p, on="k", value="price")))(*_tables(a)),
        SIZES[:4] + P4))
    out.append(Case(
        "concat_tables", ("table.py:concat_tables",), _orders,
        lambda a: (lambda o, p: (
            tbl_mod.concat_tables([o.select(["k", "v"]), o.select(["k", "v"])]),
            tbl_mod.concat_tables([o.select(["k"]), p.select(["k"])],
                                   counts=[torch.tensor(o.num_rows // 2),
                                           torch.tensor(1)])))(*_tables(a)),
        (7, TILE + 1)))
    for i, dt in enumerate(COLUMN_DTYPES):
        spec = (("rn", None, "row_number"), ("rk", None, "rank"),
                ("dr", None, "dense_rank"), ("cs", "x", "cumsum"),
                ("mn", "y", "cummin"), ("mx", "y", "cummax"),
                ("lg", "x", "lag"), ("ld", "y", "lead"))
        out.append(Case(
            f"window+window_table[{dt} order,{('auto', 'pallas', 'xla')[i]}]",
            ("ops/window.py:window", "ops/window.py:window_table"),
            lambda rng, n, dt=dt: {"p": group_keys(rng, "i32", n),
                                   "o": group_keys(rng, dt, n),
                                   "x": values(rng, "i32", n),
                                   "y": values(rng, "f32", n),
                                   "m": heads_for(rng, n, 0.8)},
            lambda a, i=i, spec=spec: (
                rt.window(a["p"], a["o"], {"x": a["x"], "y": a["y"]}, spec,
                          valid=a["m"] if i != 1 else None, descending=i == 2,
                          scan_engine=("auto", "pallas", "xla")[i]),
                rt.ops.window.window_table({"p": a["p"], "o": a["o"], "x": a["x"]},
                                           "p", "o", (("c", "o", "cumsum"),
                                                      ("r", None, "rank")))),
            SPREAD[dt], "nan"))
    for i, dt in enumerate(COLUMN_DTYPES):
        out.append(Case(
            f"filter_sort_join[{dt} values]", ("pipeline/query.py:filter_sort_join",
                                               "pipeline/query.py:QueryStats"),
            lambda rng, n, dt=dt: dict(_join_data(rng, "u32", n),
                                       v=values(rng, dt, n)),
            lambda a: rt.pipeline.query.filter_sort_join(
                a["pk"], a["v"], a["bk"], a["bv"], 0), SPREAD[dt]))
    return out


def _comparators_and_helpers() -> list:
    import importlib

    rt = _rt()
    cs = importlib.import_module("cuda.radixsort_tpu_torch.ops.comparator_sort")
    srt = importlib.import_module("cuda.radixsort_tpu_torch.ops.sort")
    mrg = importlib.import_module("cuda.radixsort_tpu_torch.ops.merge")
    out = []
    for i, dt in enumerate(("i32", "f32", "i64")):
        out.append(Case(
            f"comparator_sort+comparator_argsort[{dt}]",
            ("ops/comparator_sort.py:comparator_sort",
             "ops/comparator_sort.py:comparator_argsort",
             "ops/comparator_sort.py:primitive_comparator",
             "ops/comparator_sort.py:less", "ops/comparator_sort.py:greater",
             "ops/comparator_sort.py:Less", "ops/comparator_sort.py:Greater"),
            lambda rng, n, dt=dt: {"k": keys(rng, dt, n), "v": payload(rng, "u64", n),
                                   "rec": {"score": values(rng, "f32", n).round(),
                                           "id": values(rng, "i32", n, 0, 3)}},
            lambda a, i=i: (
                cs.primitive_comparator(cs.less), cs.primitive_comparator(cs.Greater()),
                cs.primitive_comparator(_by_score),
                rt.comparator_sort(a["k"], cs.less, values=a["v"]),
                rt.comparator_sort(a["k"], cs.greater, stable=i != 1),
                rt.comparator_argsort(a["k"], lambda x, y: (x % 5) < (y % 5)),
                rt.comparator_sort(a["rec"], _by_score, values=a["v"]),
                rt.comparator_argsort(a["rec"], _by_score, stable=False)),
            SPREAD[COLUMN_DTYPES[i]][:1] + (TILE - 1,)))
    out.append(Case(
        "sort helpers", ("ops/sort.py:apply_permutation", "ops/sort.py:spine_scan",
                         "ops/sort.py:counting_pass_reference",
                         "ops/sort.py:full_range", "ops/sort.py:plan_passes",
                         "ops/merge.py:ordered_i64"),
        lambda rng, n: {"p": torch.from_numpy(rng.permutation(n)).to(torch.int32),
                        "k": keys(rng, "u32", n), "k8": keys(rng, "u64", n),
                        "d": torch.from_numpy(rng.integers(0, 16, TILE * 2)).to(torch.int32),
                        "h": torch.from_numpy(rng.integers(0, 99, (5, 16))).to(torch.int32)},
        lambda a: (srt.apply_permutation(a["p"], [a["k"], a["k8"]]),
                   srt.spine_scan(a["h"]),
                   srt.counting_pass_reference(a["d"], 16, TILE),
                   srt.full_range(torch.uint32, 0, 32), srt.full_range(torch.int16, 3, None),
                   srt.plan_passes(3, 61, 8), mrg.ordered_i64(a["k"]),
                   mrg.ordered_i64(a["k8"]), mrg.ordered_i64(a["k"][:5].to(torch.uint8))),
        (7, TILE + 1)))
    return out


def _flagships() -> list:
    from cuda.radixsort_tpu_torch.models import flagships as fl

    out = []
    mean_tol = lambda a: 1e-3  # noqa: E731  (outer_join_agg: means of ints < 2^12)
    for name, recipe in fl.REGISTRY.items():
        def make(rng, n, recipe=recipe, name=name):
            gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31)))
            nb = {"n_build": n // 16 + 1} if name in ("table_query",) else (
                {"n_probe": n, "n_build": n // 16 + 1}
                if name in ("fk_join", "outer_join_agg", "filter_sort_join_query")
                else {})
            fn, args = (recipe(generator=gen, device="cpu", **nb) if "n_probe" in nb
                        else recipe(n, generator=gen, device="cpu", **nb))
            return {"fn": fn, "args": list(args)}

        out.append(Case(
            f"flagships.{name}", (f"models/flagships.py:{name}",
                                  "models/flagships.py:REGISTRY"),
            make, lambda a: a["fn"](*a["args"]), (TILE + 1,),
            "close" if name == "outer_join_agg" else "bits", atol=mean_tol))
    return out


H, S, C, T = ("digit_histograms",), ("partition_stage",), ("segmented_scan",), \
    ("bitonic_tile",)
# case id (by its start; the first match wins) -> the kernels it launches on
# the card at every size above 1. Left out: the routes of plain torch (the
# reference engine, the xla scan engine, prod scans, rank-scatter merges,
# the comparator network, the compat calls of elementwise torch).
NEEDS = (
    ("sort_pairs[u32+i32,bitonic split", T), ("sort_pairs[i32+", ()),
    ("sort[", None), ("argsort[", None), ("sort_pairs[", None),
    ("sort_struct[", H + S), ("segmented_sort[f32,bitonic]", T + C),
    ("segmented_sort[", H + S + C), ("merge_sorted[i16,bitonic", T),
    ("merge_sorted[u64,bitonic", T), ("merge_sorted[", ()),
    ("set_", H), ("sort_large[", H + S), ("join", H + S + C),
    ("groupby", H + S + C), ("segmented_scan[prod", ()), ("scan_by_key[prod", ()),
    ("segmented_scan[sum,xla", ()), ("segmented_scan[min,xla", ()),
    ("segmented_scan[max,xla", ()), ("scan_by_key[sum,xla", ()),
    ("segmented_scan[", C), ("scan_by_key[", C), ("reduce_with", C),
    ("filter_columns", H + S), ("partition", H + S), ("unique", H + S),
    ("kth_value", H + S + C), ("histogram_even", H),
    ("cub.DeviceRadixSort", H + S), ("cub.DeviceSegmented", H + S),
    ("cub.DeviceSelect", H + S), ("cub.DeviceRunLengthEncode", H + S),
    ("cub.DeviceHistogram", H), ("cub.DeviceScan", C),
    ("cub.DeviceReduce", H + S + C), ("cub.DeviceTopK", H + S + C),
    ("cub.DeviceMergeSort", H + S), ("cub.", ()),
    ("thrust.sorts", H + S), ("thrust.merges", H + S), ("thrust.unique", H + S),
    ("thrust.reductions", H + S + C), ("thrust.", ()),
    ("Query[distinct]", H + S), ("Query[", H + S + C), ("Table", H + S + C),
    ("concat_tables", H + S), ("window", H + C), ("filter_sort_join", H + S + C),
    ("comparator", ()), ("sort helpers", ()), ("flagships.sort", H + S),
    ("flagships.", H + S + C),
)


def _needs(case_id: str) -> tuple:
    """The kernels a case must launch (NEEDS); for sort, argsort and
    sort_pairs by engine: the radix pipeline's two, the network's tile
    kernel, the reference none. A bit range, a narrow key or an 8-byte
    payload take the network's stable radix fallback."""
    for prefix, needs in NEEDS:
        if case_id.startswith(prefix):
            if needs is not None:
                return needs
            if ",reference" in case_id:
                return ()
            if ",bitonic," in case_id and case_id.startswith(("sort[", "argsort[")) \
                    and "bits" not in case_id:
                return T
            return H + S
    raise KeyError(f"no NEEDS entry for {case_id!r}")


def all_cases() -> list:
    """Every case of the table, in a fixed order, with its NEEDS."""
    cases = (_sort_family() + _operators() + _cub_cases() + _thrust_cases()
             + _query_layer() + _comparators_and_helpers() + _flagships())
    return [dataclasses.replace(c, needs=_needs(c.id)) for c in cases]


# ---------------------------------------------------------------------------
# Coverage: every public name of the swept modules is in a case or here.

PKG = pathlib.Path(__file__).resolve().parent.parent / "cuda" / "radixsort_tpu_torch"
SWEPT = ("ops/sort.py", "ops/segmented.py", "ops/merge.py", "ops/setops.py",
         "ops/join.py", "ops/aggregate.py", "ops/scan.py", "ops/filter.py",
         "ops/partition.py", "ops/unique.py", "ops/select.py",
         "ops/histogram.py", "ops/window.py", "ops/comparator_sort.py",
         "table.py", "pipeline/plan.py", "pipeline/query.py", "cub_compat.py",
         "thrust_compat.py", "models/flagships.py", "ops/external.py")
# classes whose public methods count as names of their own
METHOD_CLASSES = {"table.py": ("Table",), "pipeline/plan.py": ("Query",),
                  "cub_compat.py": "*"}
CONFIG = "configuration, no tensor"
DISTRIBUTED = "chip_smoke.py phase 6d (distributed) and the gloo tests"
COUNTER = "a program counter the benchmark reads, no tensor"
EXTERNAL = ("host arrays in and out: tests/test_torch_external.py and "
            "chip_smoke.py's external phase")
EXCLUDED = {
    "ops/sort.py:STAGED_BYTES": COUNTER,
    "pipeline/plan.py:TAIL_ROWS": COUNTER,
    "ops/aggregate.py:REDUCED_ROWS": COUNTER,
    "ops/aggregate.py:ONE_PASS_ROWS": COUNTER,
    "ops/external.py:LINK_BYTES": COUNTER,
    "ops/external.py:MERGED_ROWS": COUNTER,
    "ops/external.py:sort_external": EXTERNAL,
    "ops/external.py:sort_external_pairs": EXTERNAL,
    "ops/external.py:sort_external_file": EXTERNAL,
    "ops/external.py:sort_external_pairs_file": EXTERNAL,
    "ops/external.py:join_external": EXTERNAL,
    "ops/scan.py:ENGINES": CONFIG,
    "ops/filter.py:compaction_config": CONFIG,
    "ops/partition.py:HASH_MUL": CONFIG,
    "ops/partition.py:HASH_MUL2": CONFIG,
    "ops/window.py:SCAN_ENGINES": CONFIG,
    "ops/window.py:WINDOW_FNS": CONFIG,
    "models/flagships.py:PROBE_VALUE_RANGE": CONFIG,
    "table.py:Table.shard": DISTRIBUTED,
    "table.py:Table.from_partition": DISTRIBUTED,
    "table.py:groupby_distributed": DISTRIBUTED,
    "table.py:join_distributed": DISTRIBUTED,
    "table.py:sort_distributed": DISTRIBUTED,
    "pipeline/query.py:filter_sort_join_distributed": DISTRIBUTED,
}


def public_names(path: pathlib.Path) -> set:
    """Names a module defines at its top level (functions, classes,
    assignments) and, in a package's __init__.py, the names it imports
    from the package itself (its re-exports); none with a leading _."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {e.id for t in targets for e in ast.walk(t)
                      if isinstance(e, ast.Name)}
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and (node.module or "").startswith("cuda.radixsort_tpu")):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _public_methods(path: pathlib.Path, classes) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.ClassDef) and not node.name.startswith("_")
                and (classes == "*" or node.name in classes)):
            for f in node.body:  # methods, and aliases assigned in the body
                names = ([f.name] if isinstance(f, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef))
                         else [t.id for t in getattr(f, "targets", ())
                               if isinstance(t, ast.Name)])
                out |= {f"{node.name}.{m}" for m in names
                        if not m.startswith("_")}
    return out


def swept_names() -> set:
    """"module:name" for every public name of the swept modules, and
    "module:Class.method" for the public methods of METHOD_CLASSES."""
    out = set()
    for rel in SWEPT:
        path = PKG / rel
        names = public_names(path)
        if rel in METHOD_CLASSES:
            names |= _public_methods(path, METHOD_CLASSES[rel])
        out |= {f"{rel}:{n}" for n in names}
    return out


def uncovered(cases=None) -> tuple:
    """(names in neither a case nor EXCLUDED, case covers that name no
    public name, EXCLUDED entries that name none)."""
    names = swept_names()
    covered = {c for case in (all_cases() if cases is None else cases)
               for c in case.covers}
    covered |= {c.rsplit(".", 1)[0] for c in covered
                if "." in c.partition(":")[2]}  # a class, by its methods
    return (sorted(names - covered - set(EXCLUDED)), sorted(covered - names),
            sorted(set(EXCLUDED) - names))
