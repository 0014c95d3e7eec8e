"""python -m meshvae_tpu_torch.plot_losses history1.json [history2.json
...] [-d] [-o out.png] [-c config.cfg]: plot the training histories that
the port's drivers write, as the JAX package's plotLosses.py does.

One panel per metric of the first file's validation records (three
columns), each with the training and validation curves of every file
(one line style per file, the file's name in the legend when there are
several), and a text block with the total training time and, with -c, the
config's scalar values as ``meshvae_tpu_torch.config.read_config`` reads
them.

What is plotted (``load_histories``, ``curves``, ``text_block``) is apart
from the drawing (``draw``), which alone imports matplotlib: -o writes the
figure, -d shows it, and without matplotlib either exits 2 with a message
naming it. With neither flag the text block and one line per curve are
printed. Host-only: no device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from .config import read_config

SPLITS = ("training", "validation")
STYLES = ("-", "--", ":", "-.")  # line style per history file
NCOLS = 3


def format_timespan(seconds: float) -> str:
    seconds = int(seconds)
    parts = []
    for unit, width in (("hour", 3600), ("minute", 60), ("second", 1)):
        value, seconds = divmod(seconds, width)
        if value:
            parts.append(f"{value} {unit}{'s' if value != 1 else ''}")
    return ", ".join(parts) if parts else "0 seconds"


def load_histories(paths) -> list[tuple[str, list[dict]]]:
    """[(file name, epoch records)] in the order given."""
    folds = []
    for path in paths:
        with open(path, "r") as fp:
            folds.append((os.path.basename(path), json.load(fp)))
    return folds


def title(folds) -> str:
    return ", ".join(name for name, _ in folds)


def curves(folds) -> list[dict]:
    """One panel per metric of the first file's validation records:
    {"metric", "label" (the metric with spaces), "xlim" (0, last epoch of
    any file), "lines": [{"label", "style", "x" epochs, "y" values}]},
    for each file the splits that record the metric."""
    metrics = list(folds[0][1][0]["validation"].keys())
    last_epoch = max(fold[-1]["epoch"] for _, fold in folds)
    panels = []
    for metric in metrics:
        lines = []
        for f, (name, fold) in enumerate(folds):
            epochs = [e["epoch"] for e in fold]
            for split in SPLITS:
                if metric in fold[0][split]:
                    lines.append({
                        "label": (split if len(folds) == 1
                                  else f"{split} [{name}]"),
                        "style": STYLES[f % len(STYLES)],
                        "x": epochs,
                        "y": [e[split][metric] for e in fold],
                    })
        panels.append({"metric": metric, "label": metric.replace("_", " "),
                       "xlim": (0, last_epoch), "lines": lines})
    return panels


def text_block(folds, config_path: str | None = None) -> str:
    """Total training time (each file's first begin to its last epoch's
    end, summed, in whole seconds rounded up) and the config's scalars."""
    duration = sum(fold[-1]["begin"] - fold[0]["begin"] + fold[-1]["duration"]
                   for _, fold in folds)
    text = "Total training time : " + format_timespan(math.ceil(duration))
    if config_path:
        text += "\nConfig : " + json.dumps(
            {k: v for k, v in read_config(config_path).items()
             if not isinstance(v, (list, dict))})
    return text


def draw(panels: list[dict], suptitle: str, text: str,
         display: bool = False, output: str | None = None):
    """The figure of plotLosses.py; raises ImportError without
    matplotlib. Returns the figure."""
    import matplotlib
    if not display:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nrows = max(1, -(-len(panels) // NCOLS))
    figure, axes = plt.subplots(nrows, NCOLS, figsize=(18, 10), squeeze=False)
    figure.suptitle(suptitle, fontsize=16)
    for ax, panel in zip(axes.ravel(), panels):
        ax.set_xlabel("epoch")
        ax.set_ylabel(panel["label"])
        ax.set_xlim(*panel["xlim"])
        for line in panel["lines"]:
            ax.plot(line["x"], line["y"], line["style"], label=line["label"])
        ax.legend(title=panel["label"], loc="center right", fontsize="small")
    for ax in axes.ravel()[len(panels):]:
        ax.set_visible(False)
    figure.text(0.1, 0.15, text, wrap=True)
    if display:
        plt.show()
    if output:
        plt.savefig(output)
    return figure


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Plot training history",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("JSONFile", nargs="+",
                        help="JSON training history file(s); several files "
                             "overlay as one curve set per fold")
    parser.add_argument("-d", "--display", help="Display plot on screen",
                        action="store_true")
    parser.add_argument("-o", "--output", help="output file")
    parser.add_argument("-c", "--config", help="model and training config file")
    args = parser.parse_args(argv)

    folds = load_histories(args.JSONFile)
    panels = curves(folds)
    text = text_block(folds, args.config)
    if not (args.display or args.output):
        print(text)
        for panel in panels:
            for line in panel["lines"]:
                print(f"{panel['metric']} {line['label']}: "
                      f"{len(line['x'])} epochs, last {line['y'][-1]}")
        return 0
    try:
        draw(panels, title(folds), text, args.display, args.output)
    except ImportError as exc:
        print(f"plot_losses: drawing (-o, -d) needs matplotlib, which did "
              f"not import ({exc})", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
