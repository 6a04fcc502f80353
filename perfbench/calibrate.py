"""The readings that a cell's limits are set from: on each seed, the
program's numbers against the reference, and the control's (the reference
in TF32 put in the program's place, judged against the same fp32
reference), at the cell's own size, in one process:

    python3 -m perfbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file>]

One line a seed (JSON): the seed, the program's and the control's numbers,
the run's end-to-end metrics, and every compared answer's readings
(``answers``: distance, step, the program's and the reference's flags). The
benchmark's own runs never run the control; this is how the limits
(``check.limits`` of ``perfbench/configs/<config>.json``) were chosen,
and ``PERF.md`` gives the readings. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT / "src"))
    from perfbench.run import run_cell
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            out = run_cell(args.workload, seed, args.seconds, False,
                           control=True)
            row = {"seed": seed,
                   "program": {c.name: c.value for c in out["checks"]},
                   "control": {c.name: c.value for c in out["control"]},
                   "metrics": out["metrics"], "attempted": out["attempted"],
                   "failed": out["failed"],
                   "wall_s": time.perf_counter() - t,
                   "answers": out["details"]}
            # numpy arrays and scalars go out as lists and numbers
            line = json.dumps(row, default=lambda o: o.tolist())
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
