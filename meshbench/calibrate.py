"""Readings for setting the limits of a cell's correctness check, many
seeds in one process (no measured window):

    python3 -m meshbench.calibrate --workload NAME --seeds 1,2,3 \
        [--control tf32|fp8] [--fault NAME] [--out FILE]

Without --control each seed runs the program's set-up as a run does and
reads the cell's numbers against the reference (the lower readings). With
--control the reference computed at that precision stands in the
program's place (the control, whose readings bound the limits from
above). --fault plants a fault in the program (frozen_state, half_batch,
duplicate_rows). Prints one JSON line per seed and
writes them all to --out.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control")
    ap.add_argument("--fault")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from meshbench.harness import forbidden_modules, make_cell
    from meshbench.registry import ROOT, Registry
    from meshbench.run import _caches

    registry = Registry(args.root or ROOT)
    _caches(registry.root)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = make_cell(registry, args.workload, seed, 0.0, False,
                         args.device, t0, limits=None, control=args.control,
                         fault=args.fault, readings_only=True)
        out = registry.driver(cell.traffic["driver"]).run(cell)
        row = {"workload": args.workload, "seed": seed,
               "control": args.control, "fault": args.fault,
               "numbers": out.numbers,
               "seconds": time.perf_counter() - t0}
        if "readings" in out.context:
            row["loss"] = out.context["readings"]["loss"]
            row["reference_loss"] = out.context["reference"]["loss"]
            row["eval"] = {"program": out.context["readings"]["eval"],
                           "reference": out.context["reference"]["eval"]}
            if out.context["at_dtype"]:
                row["eval"]["at_dtype"] = out.context["at_dtype"]["eval"]
        print(json.dumps(row), flush=True)
        if "readings" in out.context:
            row["leaves"] = {"program": out.context["readings"],
                             "reference": out.context["reference"],
                             "at_dtype": out.context["at_dtype"]}
        rows.append(row)
    if forbidden_modules():
        print(f"the process holds {forbidden_modules()}", file=sys.stderr)
        return 3
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(rows, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
