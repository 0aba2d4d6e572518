"""The distributed layer's one door to ``torch.distributed``.

The JAX package runs its distributed operators as ``shard_map`` bodies and
calls ``jax.lax.psum`` / ``pmax`` / ``all_gather`` / ``all_to_all`` /
``axis_index`` over a named mesh axis. Here every rank runs the same
Python on its own shard (SPMD), and those collectives are these functions
over an :class:`Axis`: the process group of one dimension of a
``torch.distributed.device_mesh.DeviceMesh``, or of a tuple of its
dimensions (linearised in the tuple's order, most significant first, as
JAX linearises tuple axes).

Neither backend takes every dtype: gloo refuses 2-byte tensors and
unsigned 32-bit ones, and NCCL has no uint32 either. So data moves as a
signed view of the same width (2-byte columns widen to int32 and narrow
back), and only reductions see the value dtype (int32, int64, float32).

Tracing: while a profiler runs, each collective runs inside a
``record_function`` range ``comm.<op>`` (``comm.all_gather``,
``comm.all_to_all``, ``comm.psum``, ``comm.pmax``). :data:`SENT_BYTES`
counts the bytes every ``all_to_all`` and ``all_gather`` of this rank
sends to other ranks, padding of the lanes included.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cuda.radixsort_tpu_torch.utils import profiling

# bytes this rank's all_to_all and all_gather calls sent to other ranks
SENT_BYTES = 0

# all_gather_into_tensor is all_gather_single in newer torch (same call)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class Axis:
    """A mesh axis (one dimension name or a tuple of names) resolved to its
    process group, its size and this rank's index along it."""

    def __init__(self, mesh, axis_name):
        names = tuple(mesh.mesh_dim_names or ())
        dims = (tuple(axis_name) if isinstance(axis_name, (tuple, list))
                else (axis_name,))
        for d in dims:
            if d not in names:
                raise ValueError(f"axis {d!r} is not a dimension of the "
                                 f"mesh {names}")
        idx = [names.index(d) for d in dims]
        if idx != sorted(idx):
            raise ValueError(f"axis tuple {dims} must follow the mesh's "
                             f"dimension order {names}")
        coord = mesh.get_coordinate()
        self.size = 1
        self.index = 0
        for i in idx:
            self.index = self.index * mesh.size(i) + coord[i]
            self.size *= mesh.size(i)
        if len(dims) == 1:
            self.group = mesh.get_group(dims[0])
        else:  # created once per mesh (a collective): kept on the mesh
            groups = mesh.__dict__.setdefault("_radixsort_tuple_groups", {})
            if dims not in groups:
                groups[dims] = _tuple_group(mesh, idx)
            self.group = groups[dims]


def _tuple_group(mesh, idx):
    """The group over the mesh dimensions ``idx``: one group per value of
    the other dimensions, created on every rank in the same order (as
    ``dist.new_group`` requires); this rank's is kept."""
    ranks = mesh.mesh
    others = [i for i in range(ranks.dim()) if i not in idx]
    size = 1
    for i in idx:
        size *= ranks.shape[i]
    mine = None
    for row in ranks.permute(others + idx).reshape(-1, size).tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def axis_size(mesh, axis_name) -> int:
    return Axis(mesh, axis_name).size


def axis_index(mesh, axis_name) -> int:
    return Axis(mesh, axis_name).index


# ---------------------------------------------------------------------------
# moving bits
# ---------------------------------------------------------------------------


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor both backends move with x's bits."""
    x = x.contiguous()
    size = x.dtype.itemsize
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    if size == 1:
        return x.view(torch.int8)
    if size == 2:
        return x.view(torch.int16).to(torch.int32)
    return x.view(torch.int32 if size == 4 else torch.int64)


def _from_wire(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype.itemsize == 2:
        return w.to(torch.int16).view(dtype)
    return w.view(dtype)


def _span(op: str):
    """The range ``comm.<op>`` while a profiler runs; else no range."""
    if not profiling._profiling():
        return profiling._NO_RANGE
    return torch.profiler.record_function("comm." + op)


def _count_sent(nbytes: int) -> None:
    global SENT_BYTES
    SENT_BYTES += nbytes


def all_gather(x: torch.Tensor, ax: Axis, *, tiled: bool = False):
    """x from every rank of the axis, in axis order: stacked on a new
    leading dimension, or concatenated along the first (``tiled``). A 0-d
    x gathers to (size,)."""
    with _span("all_gather"):
        w = _to_wire(x.reshape(-1) if x.dim() == 0 else x)
        out = torch.empty((ax.size * w.shape[0],) + tuple(w.shape[1:]),
                          dtype=w.dtype, device=w.device)
        _gather_into(out, w, group=ax.group)
        _count_sent(w.numel() * w.element_size() * (ax.size - 1))
        out = _from_wire(out, x.dtype)
    if x.dim() == 0 or tiled:
        return out
    return out.reshape((ax.size,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, ax: Axis, *, async_op: bool = False):
    """Block j of x's leading dimension (of length size * lane) goes to
    rank j; block i of the result came from rank i. With ``async_op`` the
    exchange is only issued: returns a callable that waits and returns
    the result."""
    with _span("all_to_all"):
        w = _to_wire(x)
        out = torch.empty_like(w)
        work = dist.all_to_all_single(out, w, group=ax.group,
                                      async_op=async_op)
        # block j goes to rank j: all but this rank's own block leave it
        _count_sent(w.numel() * w.element_size() // ax.size
                    * (ax.size - 1))
    if not async_op:
        return _from_wire(out, x.dtype)

    def wait():
        work.wait()
        return _from_wire(out, x.dtype)
    return wait


# ---------------------------------------------------------------------------
# reductions (int32, int64, float32 and bool values)
# ---------------------------------------------------------------------------


def _reduce(x: torch.Tensor, ax: Axis, op) -> torch.Tensor:
    y = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
    y = y.contiguous()
    dist.all_reduce(y, op=op, group=ax.group)
    return y


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum over the axis (a bool sums as int32, as ``psum`` of a bool)."""
    with _span("psum"):
        return _reduce(x, ax, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    with _span("pmax"):
        return _reduce(x, ax, dist.ReduceOp.MAX)
