"""dist.glue_ms (device_trace): device milliseconds per query of the torch
kernels, copies and memsets whose innermost host range is the distributed
layer's own: a ``_dist_*`` stage of ``Query.run(mesh=)``,
``exchange_rows`` or a collective's ``comm.*`` range. The port's five
CUDA kernels and NCCL's kernels are left out: the routing, lane building,
wire conversion and compaction around the exchanges. Nothing where no op
ran under a ``comm.*`` range (a program without them)."""

import harness

PORT_KERNELS = harness.load("metrics", "ops.glue_ms").PORT_KERNELS


def is_dist(name: str) -> bool:
    return name.startswith(("_dist_", "comm.")) or name == "exchange_rows"


def read(ctx):
    if not ctx.calls or not any(r.startswith("comm.") for op in ctx.trace.ops
                                for r in op.ranges):
        return None
    glue = [op for op in ctx.trace.ops if op.ranges and is_dist(op.ranges[0])
            and "nccl" not in op.name.lower()
            and not any(k in op.name for k in PORT_KERNELS)]
    return sum(op.us for op in glue) / 1e3 / ctx.calls
