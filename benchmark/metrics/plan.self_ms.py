"""plan.self_ms (device_trace): device milliseconds per query whose
innermost host range is the query layer's own (``Query.run`` or one of its
``_exec_*`` stages): the plan's masks, valid prefixes and the glue between
stages, which no operator's range covers."""


def is_plan(name: str) -> bool:
    return name == "Query.run" or name.startswith("_exec_")


def read(ctx):
    ops = [op for op in ctx.trace.ops if "Query.run" in op.ranges]
    if not ops or not ctx.calls:
        return None
    return sum(op.us for op in ops if is_plan(op.ranges[0])) / 1e3 / ctx.calls
