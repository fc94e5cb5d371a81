"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the cell (inputs from the seed,
kernel builds on a checkout's first run, captures, warm-up), measures for
``--seconds``, compares what the window produced with the plain reference,
and prints an earlier line of checks, then the result as the last line of
standard output.  The numbers compared, each beside its limit, are the
last lines of standard error.  With ``--trace 1`` the result holds the
cell's per-layer metrics, read from a short profiled slice after the
window, and the device's busy and traced seconds.  Without a card, or with
fewer cards than the cell needs, it prints no result and exits 2; it never
falls back to the CPU.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for p in (str(ROOT), str(HERE)):
        if p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)

    from benchkit import card, cell, spec

    c = spec.cell(args.workload)
    why = card.missing(c.chips)
    if why:
        print(f"benchmark: {why}", file=sys.stderr)
        return 2
    rec = cell.run(c, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    if rec is None:
        return 3
    print(json.dumps({"checks": rec.pop("checks")}), flush=True)
    for name, v in rec["compared"].items():
        print(f"compared {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
