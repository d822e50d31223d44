#!/usr/bin/env python3
"""The benchmark of opt_tpu_torch: one cell of BENCHMARK.json on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run makes its input pool from the seed,
builds one plan and warms it up (set-up), then runs a closed loop of
Plan.solve(inputs, engine="auto") calls for the given seconds; with
--trace 1 it profiles a few more solves after the window.  Once the window
has closed it holds solves of the window against the plain float64
reference (portbench/reference/).  The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and last the numbers compared with their limits ("check"),
which also end standard error.

It exits non-zero, printing no result, where torch sees no CUDA card or
fewer than the cell asks for, and where jax, jaxlib, flax or opt_tpu (the
JAX package) is loaded once the run is done.  Every cache it or the
program writes lies under build/ in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "opt_tpu")


def process_start():
    """The process's start on the perf_counter clock, where /proc says when
    that was (Linux, to a clock tick); T_START, this file's first line,
    elsewhere."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_START
    return min(time.perf_counter() - age, T_START)


def forbidden_modules():
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root):
    """Fixed cache directories inside the checkout, for every compiler the
    program may use."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def main(argv=None):
    t_start = process_start()
    args = parse(argv)
    sys.path[0] = str(ROOT)
    cache_dirs(ROOT)
    import torch

    t_torch = time.perf_counter()
    from portbench.benchlib.runner import log, run_cell
    from portbench.benchlib.spec import load_cell, read_json

    cell = load_cell(read_json(ROOT / "BENCHMARK.json"), args.workload,
                     bool(args.trace))
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.init()
    log(f"set-up: torch imported {t_torch - t_start:.3f} s, card ready "
        f"{time.perf_counter() - t_start:.3f} s after the process's start")
    log(f"card: {power_limit()}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"the JAX package or JAX is loaded: {found}")
        return 3
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def power_limit():
    """The card's power limit as nvidia-smi prints it, or "unknown"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "unknown")


if __name__ == "__main__":
    sys.exit(main())
