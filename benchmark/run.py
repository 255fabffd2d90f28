"""Run one cell of the benchmark once, on the card.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``.  The last
line on stdout is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; then ``card``
and, last, ``checks`` (each compared number with its limit).  Everything
else, the program's own prints included, goes to stderr, whose last
lines are the compared numbers again.

Without a CUDA card, with fewer cards than the cell asks for, or when a
JAX module is loaded once the window has closed, it prints no result and
exits non-zero.  It keeps the kernels' build (``build/``, where the
program puts it) and any compiler cache inside the checkout.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "patchwork_tpu")


def process_start() -> float:
    """The process's start on the ``time.perf_counter()`` clock (from
    /proc, to the kernel's clock tick), or this module's import where
    /proc does not say."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        ticks = int(fields.split()[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info() -> dict:
    """The first card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
        name, limit = out.rsplit(",", 1)
        return {"name": name.strip(), "power_limit": limit.strip()}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": "unknown", "power_limit": "unknown"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    if args.seed < 0:
        print("run: --seed must be a whole number >= 0", file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import torch

    from .harness import log, run_cell
    from .manifest import Manifest

    bench = Manifest(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible. There is no CPU mode.", file=sys.stderr)
        return 2
    card = card_info()
    log(f"{card['name']}, power limit {card['power_limit']}; "
        f"{args.workload}, seed {args.seed}, {args.seconds} s, "
        f"trace {args.trace}")
    with contextlib.redirect_stdout(sys.stderr):
        line = run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0), t_start,
                        card)
    leaked = forbidden_modules()
    if leaked:
        print(f"run: JAX modules loaded in the benchmark's process: "
              f"{leaked}; no result", file=sys.stderr)
        return 3
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
