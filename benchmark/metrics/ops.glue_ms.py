"""ops.glue_ms (device_trace): device milliseconds per query of torch
kernels, memcpys and memsets whose innermost host range is an operator's
(a ``traced`` range that is not the query layer's), leaving out the port's
five CUDA kernels: the operators' torch glue."""

PORT_KERNELS = ("stage_onesweep", "hist_kernel", "scan_single_pass",
                "bitonic_tile", "bitonic_cross")


def is_operator(name: str) -> bool:
    return not (name == "Query.run" or name.startswith(("_exec_", "bench.")))


def read(ctx):
    ops = [op for op in ctx.trace.ops if "Query.run" in op.ranges]
    if not ops or not ctx.calls:
        return None
    glue = [op for op in ops if is_operator(op.ranges[0])
            and not any(k in op.name for k in PORT_KERNELS)]
    return sum(op.us for op in glue) / 1e3 / ctx.calls
