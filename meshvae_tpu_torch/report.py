"""python -m meshvae_tpu_torch.report inference.json [-p] [-e] [-j]
[--top N]: analyse the results that ``python -m meshvae_tpu_torch.infer``
writes, with the flags and the text and JSON output of the JAX package's
report.py.

  * -p: per-class and overall sex-prediction accuracy, and each
    misclassified mesh with its reconstruction errors;
  * -e: the meshes sorted by max reconstruction error (ascending; ties
    keep the file's order), the N worst with --top N;
  * -j / --json: one machine-readable summary instead of the text.

Input schema: {filename: {"sex": 0|1, "reconstruction_error": {"max":
float, "mean": float}}}. The ground-truth sex is the filename's second
``_``-separated token (f = 0, m = 1), as the dataset loader reads it.
Host-only: standard library, no device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys


def label_from_name(name: str) -> int:
    return 0 if name.split("_")[1] == "f" else 1


def prediction_report(data: dict) -> dict:
    """Per-class and overall sex-prediction accuracy and the misclassified
    meshes with their reconstruction errors."""
    wrong = []
    per_class = {0: {"total": 0, "correct": 0}, 1: {"total": 0, "correct": 0}}
    for name, record in data.items():
        truth = label_from_name(name)
        per_class[truth]["total"] += 1
        if truth == record["sex"]:
            per_class[truth]["correct"] += 1
        else:
            wrong.append((name, record["reconstruction_error"]))
    total = len(data)
    return {
        "total": total,
        "wrong": wrong,
        "accuracy": 100.0 * (total - len(wrong)) / total if total else 0.0,
        "per_class": {
            {0: "f", 1: "m"}[c]: (100.0 * v["correct"] / v["total"]
                                  if v["total"] else None)
            for c, v in per_class.items()
        },
    }


def error_summary(data: dict) -> dict:
    """Distribution of the per-mesh reconstruction errors."""
    if not data:
        return {"count": 0}
    means = [r["reconstruction_error"]["mean"] for r in data.values()]
    maxes = [r["reconstruction_error"]["max"] for r in data.values()]
    return {
        "count": len(data),
        "mean_error": {"mean": statistics.fmean(means),
                       "median": statistics.median(means)},
        "max_error": {"mean": statistics.fmean(maxes),
                      "median": statistics.median(maxes),
                      "worst": max(maxes)},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Analyse inference results",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("JSONFile", help="JSON inference results file")
    parser.add_argument("-p", help="Analyse sex prediction results",
                        action="store_true")
    parser.add_argument("-e", help="List max reconstruction errors",
                        action="store_true")
    parser.add_argument("-j", "--json", help="print a machine-readable "
                        "summary instead of text", action="store_true")
    parser.add_argument("--top", type=int, default=0,
                        help="with -e, list only the N worst meshes "
                             "(0 = all)")
    args = parser.parse_args(argv)
    with open(args.JSONFile, "r") as fp:
        data = json.load(fp)

    by_max_error = sorted(
        data.items(), key=lambda kv: kv[1]["reconstruction_error"]["max"])
    if args.top:
        by_max_error = by_max_error[-args.top:]

    if args.json:
        summary = {"predictions": len(data), "errors": error_summary(data)}
        if args.p:
            report = prediction_report(data)
            summary["prediction"] = {
                "accuracy_pct": report["accuracy"],
                "per_class_accuracy_pct": report["per_class"],
                "wrong": [name for name, _ in report["wrong"]],
            }
        if args.e:
            summary["sorted_max_errors"] = [
                {"name": name, "max": rec["reconstruction_error"]["max"]}
                for name, rec in by_max_error]
        print(json.dumps(summary, indent=2))
        return 0

    if args.p:
        report = prediction_report(data)
        for name, err in report["wrong"]:
            print(f"{name}: wrong prediction")
            print(f"reconstruction error : max= {err['max']}, "
                  f"mean= {err['mean']}")

    print(f"{len(data)} predictions")
    if args.p:
        print(f"{len(report['wrong'])} wrong predictions. "
              f"Accuracy : {report['accuracy']:.2f}%")
        for cls, acc in report["per_class"].items():
            if acc is not None:
                print(f"  class {cls}: {acc:.2f}%")

    if args.e:
        print("Sorted max errors:")
        for name, record in by_max_error:
            print(f"{name} : {record['reconstruction_error']['max']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
