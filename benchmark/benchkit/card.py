"""The card: whether it is there, what it is, and its published peaks."""

from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit: float32
# outside the tensor cores, and HBM3 bandwidth.  The kernels' roofline
# shares are stated against these, with the card's power limit beside them.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> tuple:
    """(the least seconds the card needs for ``flops`` operations and
    ``nbytes`` bytes, "operations" or "bytes": which of the two bounds it)."""
    t_op, t_b = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def roofline_share(ctx, events: tuple, work) -> float | None:
    """100 x the least time for one call's work (``work(rows, samples,
    reference kwargs)``) over the device time a call of the kernel events
    whose names hold any of ``events``; None where the trace has none."""
    t = ctx.trace
    if t is None or not t.calls or not t.count(*events):
        return None
    least, _ = least_seconds(*work(*ctx.work_shape, ctx.config["reference"]["kwargs"]))
    return 100.0 * least / (t.device_s(*events) / t.calls)


_QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"


def missing(chips: int) -> str | None:
    """Why this process cannot measure a cell on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: every number of the benchmark is measured on the card"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible"
    return None


def smi() -> dict:
    """``nvidia-smi``'s reading of card 0 (name, power limit and draw, SM
    clock and its maximum, temperature), as strings; empty if it fails."""
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={_QUERY}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    values = [v.strip() for v in res.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(_QUERY.split(","), values))
