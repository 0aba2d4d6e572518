"""exchange.roofline_pct (device_trace): the exchanges' share of the links'
rate. The bytes rank 0 sent to other ranks in the traced window (the delta
of ``parallel/comm.py::SENT_BYTES``) over the card's NVLink rate in one
direction (``benchmark/links.py``), against the summed device time of the
kernels whose name holds ``nccl``, in percent. The kernels are picked by
name: NCCL launches them itself. Their time includes the wait for the
slowest rank. Nothing for a card with no listed rate."""

import importlib

import torch

import links


def _sent():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.parallel.comm"), "SENT_BYTES", None)


def start(ctx):
    ctx.state["exchange.roofline_pct"] = _sent()


def nccl_us(trace) -> float:
    return sum(op.us for op in trace.ops if "nccl" in op.name.lower())


def read(ctx):
    if not ctx.on_card:
        raise RuntimeError("exchange.roofline_pct is a device metric: "
                           "no card")
    before, now = ctx.state["exchange.roofline_pct"], _sent()
    rate = links.nvlink_bytes_per_s(torch.cuda.get_device_name(0))
    us = nccl_us(ctx.trace)
    if before is None or now == before or not us or rate is None:
        return None
    return 100.0 * (now - before) / rate / (us / 1e6)
