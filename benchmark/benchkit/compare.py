"""The comparisons that decide ``correct``: an answer against the plain
reference, as one number per kind of answer."""

from __future__ import annotations

import math

import torch

LIBROSA_FLOOR = 0.02  # the mel power's absolute floor, in max|ref|


def rel_to_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref|: features whose size is set by their
    largest values (cepstra, log energies)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def mixed(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / (|ref| + 0.02 max|ref|): a power spectrum, whose
    small bins are held relative to themselves down to a floor."""
    got, ref = got.double(), ref.double()
    floor = LIBROSA_FLOOR * ref.abs().max()
    return float(((got - ref).abs() / (ref.abs() + floor).clamp_min(1e-300)).max())


KINDS = {"rel_to_max": rel_to_max, "mixed": mixed}


def answer_err(kind: str, got, ref) -> float:
    """The comparison ``kind`` of one answer; inf where the shapes differ or
    the answer is not finite."""
    got = torch.as_tensor(got).to(ref.device)
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    if got.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return KINDS[kind](got, ref)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, compared): every number that has a limit reads at or under
    it; ``compared`` maps each to its reading and limit.  A limit whose
    number was not read is not correct."""
    compared, ok = {}, True
    for name in sorted(limits):
        value, limit = numbers.get(name), limits[name]["limit"]
        ok &= value is not None and value <= limit
        compared[name] = {"value": value, "limit": limit}
    return ok, compared
