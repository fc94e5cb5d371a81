"""Readings that the limits of ``limits/<workload>.json`` are set from, on
the card, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 2

For each seed: the cell's set-up and a short window of its timed path at
the cell's own sizes, then every number that decides ``correct`` read twice
against the reference: from the program's answers (the lower reading is
the largest over the seeds) and from the control, the reference in TF32 put
in the program's place (the upper reading is the smallest).  One JSON line
a seed; the benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from benchkit import card, cell, spec

    c = spec.cell(args.workload)
    if args.device == "cuda":
        why = card.missing(c.chips)
        if why:
            print(f"calibrate: {why}", file=sys.stderr)
            return 2
    dev = torch.device(args.device)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = cell.Context(c, seed % (1 << 63), dev)
        drv = spec.driver(c.traffic["kind"]).Driver(ctx)
        drv.setup()
        w = drv.window(args.seconds)
        drv.release()
        cell.free_program()
        prog = drv.numbers("program")
        ctl = drv.numbers("control")
        drv.close()
        row = {"workload": c.name, "seed": seed, "attempted": w["attempted"],
               "program": {k: v for k, v in prog.items() if not k.startswith("_")},
               "control": {k: v for k, v in ctl.items() if not k.startswith("_")},
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del drv, ctx
        cell.free_program()
    names = sorted(rows[0]["program"])
    summary = {n: {"lower": max(r["program"][n] for r in rows),
                   "upper": min(r["control"][n] for r in rows)} for n in names}
    print(json.dumps({"workload": c.name, "seeds": len(rows), "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
