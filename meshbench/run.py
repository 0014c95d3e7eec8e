"""Run one cell of BENCHMARK.json once and print its result:

    python3 -m meshbench.run --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is the result, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, with --trace 1 a breakdown,
and last the numbers of the correctness check beside their limits, which
also close standard error. Exits non-zero with no result when the machine
lacks the cards the cell asks for, or when the process holds JAX or the
JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _caches(root: str) -> None:
    """Every compiler cache at a fixed directory inside the checkout."""
    base = os.path.join(root, "meshbench", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from meshbench.registry import Registry

    registry = Registry()
    chips = int(registry.workload(args.workload)["chips"])
    _caches(registry.root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from meshbench.harness import forbidden_modules, make_cell, run_cell

    cell = make_cell(registry, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START)
    result, lines = run_cell(registry, cell)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
