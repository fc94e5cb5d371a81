"""Array-utility parity shims on tensors (port of
``mfcc_rust_tpu.utils.padding``; reference: speechsauce/src/util.rs):

* ``pad``         — util.rs:75-125 (Constant / Symmetric / Edge np.pad)
* ``repeat_axis`` — util.rs:20-25 (np.tile along an axis)
* ``pad_center``  — util.rs:40-63 (librosa-style center pad)
* ``array_log``   — util.rs:372-381 (the ArrayLog trait's elementwise ln)

``pad`` follows ``np.pad`` on any axis and any width.
``torch.nn.functional.pad`` cannot stand in for it: it has no
``"symmetric"`` mode, pads only the last one to three dims in its other
modes, and refuses pads as wide as the axis, which ``np.pad`` serves by
reflecting again.  So every axis but a constant one is built from index
arithmetic: the padded positions map back into the axis by the mode's
reflection, and one ``index_select`` gathers them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as tF

PAD_MODES = ("constant", "symmetric", "edge", "reflect")


def _source_index(n: int, before: int, after: int, mode: str) -> torch.Tensor:
    """For each of the ``before + n + after`` padded positions of an axis of
    length n, the index of the element ``np.pad`` puts there."""
    i = torch.arange(-before, n + after)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    if mode == "symmetric":  # ... 1 0 | 0 1 ... n-1 | n-1 n-2 ...
        period = 2 * n
        j = i % period
        return torch.where(j < n, j, period - 1 - j)
    period = 2 * (n - 1)  # reflect: ... 2 1 | 0 1 ... n-1 | n-2 ...
    j = i % period
    return torch.where(j < n, j, period - j)


def pad(
    x: torch.Tensor,
    pad_width: Sequence[Tuple[int, int]],
    mode: str = "constant",
    constant_value: float = 0.0,
) -> torch.Tensor:
    """``np.pad(x, pad_width, mode)`` on a tensor: util.rs's
    PadType::{Constant,Symmetric,Edge}, plus "reflect"; ``pad_width`` holds
    one (before, after) pair per axis."""
    if mode not in PAD_MODES:
        raise ValueError(f"unknown pad mode {mode!r}; expected one of {PAD_MODES}")
    widths = [tuple(int(v) for v in w) for w in pad_width]
    if len(widths) != x.ndim:
        raise ValueError(f"pad_width has {len(widths)} pairs for a {x.ndim}-D tensor")
    if mode == "constant":
        flat = [v for w in reversed(widths) for v in w]
        return tF.pad(x, flat, value=constant_value)
    for axis, (before, after) in enumerate(widths):
        if before == after == 0:
            continue
        n = x.shape[axis]
        if n == 0:
            raise ValueError(f"cannot {mode}-pad the empty axis {axis}")
        idx = _source_index(n, before, after, mode).to(x.device)
        x = x.index_select(axis, idx)
    return x


def repeat_axis(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Tile ``x`` n times along ``axis`` (util.rs:20-25)."""
    reps = [1] * x.ndim
    reps[axis] = n
    return x.repeat(*reps)


def pad_center(w: torch.Tensor, size: int) -> torch.Tensor:
    """Center-pad the last axis to ``size`` (util.rs:40-63; the reference
    left its test as todo!())."""
    n = w.shape[-1]
    if size < n:
        raise ValueError(f"target size {size} < input size {n}")
    lpad = (size - n) // 2
    return tF.pad(w, (lpad, size - n - lpad))


def array_log(x: torch.Tensor) -> torch.Tensor:
    """Elementwise natural log (the ArrayLog trait, util.rs:372-381)."""
    return torch.log(x)
