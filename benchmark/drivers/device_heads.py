"""Device-resident batches through an ``api`` entry point that answers
several heads a call (``api.extract``), in a cycle.

Traffic parameters (``traffic/<name>.json``, ``"kind": "device_heads"``):
those of ``drivers/device_loop.py``, whose set-up, window, traced slice and
enqueue probe this driver keeps as they are.  What it changes is the
comparison: an answer is a dict of heads (``"mfe"`` a (features, frame
energies) pair), and each head is judged by its own number against the
configuration's ``reference`` (a function of ``reference/speechpy_suite.py``
that gives the same dict):

* ``mfe_max_err``, ``energy_max_err``: ``compare.mixed`` (mel powers and
  frame energies, small values held relative to themselves down to a
  floor);
* ``lmfe_max_err``, ``ssc_max_err``, ``mfcc_max_err``: ``compare.rel_to_max``.

The configuration's ``compare`` maps each number to its kind.  A missing
head, a wrong shape or a non-finite value reads inf.  Each number is the
worst over the kept answers; an answer fails where any of its numbers is
over its limit.
"""

from __future__ import annotations

import math

from benchkit import compare, spec
from reference import speechpy_suite

_loop = spec.driver("device_loop")


def heads(answer) -> dict:
    """{number name: tensor} of one answer of the suite (a dict of heads)."""
    out = {}
    for name, val in answer.items():
        if name == "mfe":
            out["mfe_max_err"], out["energy_max_err"] = val
        else:
            out[f"{name}_max_err"] = val
    return out


def errors(kinds: dict, got, ref) -> dict:
    """{number: reading} of one answer ``got`` against the reference's
    ``ref``, for every number of ``kinds``."""
    g, r = heads(got), heads(ref)
    return {n: compare.answer_err(kind, g[n], r[n]) if n in g else math.inf
            for n, kind in kinds.items()}


class Driver(_loop.Driver):
    def numbers(self, source: str = "program") -> dict:
        """The worst kept answer's reading of each head against the
        reference (``source="program"``), or the control in the program's
        place on the same batches (``"control"``)."""
        cfg = self.ctx.config
        ref_cfg = cfg["reference"]
        fn = speechpy_suite.FUNCTIONS[ref_cfg["function"]]
        kinds = cfg["compare"]
        worst = dict.fromkeys(kinds, 0.0)
        failed = 0
        by_batch: dict = {}
        for i, (b, out) in sorted(self.kept.items()):
            by_batch.setdefault(b, []).append(out)
        for b, outs in sorted(by_batch.items()):
            x = self.xs[b]
            ref = fn(x, precision="float64", **ref_cfg["kwargs"])
            if source == "control":
                outs = [fn(x, precision="tf32", **ref_cfg["kwargs"])]
            for out in outs:
                errs = errors(kinds, out, ref)
                for n, e in errs.items():
                    worst[n] = max(worst[n], e)
                failed += not all(e <= self.ctx.limit(n) for n, e in errs.items())
            del ref
        return {**worst, "_failed": failed, "_compared": len(self.kept)}
