#!/usr/bin/env python3
"""The two readings that the output check's limits are set from, for one
cell, on the card, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 [--out FILE]

For each seed of --seeds: the cell's pool from that seed, a short closed
loop on one plan (one solve of every pool entry),
and the check's numbers against the float64 reference, as a run of
run.py computes them: the program's reading, whose largest over the seeds
is the lower reading.  For each seed of --control-seeds: the reference
computed in bfloat16, the precision below the configuration's float32
(the solver has no matrix product, so TF32 does not apply), put in the
program's place on the same sampled entries and judged by the same
numbers: the control's reading, whose smallest is the upper one.  One
JSON line a seed on standard output, and in FILE.  The benchmark's own
runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seed_list(text):
    """"1-12" or "1,5,9" -> [ints]."""
    out = []
    for part in text.split(","):
        if "-" in part.strip()[1:]:
            a, b = part.split("-", 1)
            out.extend(range(int(a), int(b) + 1))
        elif part.strip():
            out.append(int(part))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seed_list, required=True)
    ap.add_argument("--control-seeds", type=seed_list, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from portbench.benchlib import check, window
    from portbench.benchlib.runner import check_window, keep_last, log
    from portbench.benchlib.spec import load_cell, read_json

    cell = load_cell(read_json(ROOT / "BENCHMARK.json"), args.workload,
                     False)
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    plan = window.new_plan(cell, "cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            pool = window.make_pool(cell, seed)
            entries = check.sample(seed, len(pool),
                                   int(cell.traffic["check_entries"]))
            loop = window.Loop(plan, pool, keep=frozenset(entries))
            if n == 0:
                for _ in range(int(cell.traffic["warmup"])):
                    loop.solve()
            solves, _ = loop.window(0, min_solves=len(pool))
            numbers, failed, refs = check_window(
                cell, pool, solves, entries, keep_last(loop), "cuda")
            row = {"workload": cell.name, "seed": seed,
                   "engine": plan.engine, "variant": plan.variant,
                   "entries": entries, "solves": len(solves),
                   "failed": failed, "program": numbers}
            if seed in args.control_seeds:
                rows = []
                for e in entries:
                    ref_cost, ref_x, x0 = refs[e]
                    c, x, _ = check.reference_solve(cell, pool[e],
                                                    "cuda",
                                                    torch.bfloat16)
                    rows.append(check.gaps(c, x, ref_cost, ref_x, x0))
                row["control"] = check.worst(rows)
            row["seconds"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
