"""lsd.passes (program_counter): stage-kernel launches per sort call, from
the delta of ``kernels/stage.py::LAUNCHES`` over the traced window."""

import importlib


def _launches() -> int:
    return importlib.import_module(
        "cuda.radixsort_tpu_torch.kernels.stage").LAUNCHES


def start(ctx):
    ctx.state["lsd.passes"] = _launches()


def read(ctx):
    launches = _launches() - ctx.state["lsd.passes"]
    return launches / ctx.calls if launches and ctx.calls else None
