"""The port's post-hoc entry points against the root scripts: python -m
meshvae_tpu_torch.report against report.py (byte-equal output for every
flag combination, on a synthetic inference.json in the inference CLI's
schema with ties in the max errors), and meshvae_tpu_torch.plot_losses
against plotLosses.py (the curves, panel layout, title and text block of
the figure plotLosses.py draws, with -c read by each package's config)."""
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

from meshvae_tpu_torch import plot_losses, report
from meshvae_tpu_torch.train.metrics import history_record

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "files", "default.cfg")

FLAGS = [[], ["-p"], ["-e"], ["-p", "-e"], ["-e", "--top", "3"], ["-j"],
         ["-j", "-p", "-e"], ["-p", "-e", "-j", "--top", "2"]]


def _inference_json(path, sexes=("f", "m"), n=9, seed=0):
    """{name: {"sex", "reconstruction_error": {"mean", "max"}}} as the
    inference CLI writes it; max errors on a coarse grid, so some tie."""
    rng = np.random.default_rng(seed)
    data = {}
    for i in range(n):
        sex = sexes[i % len(sexes)]
        data[f"s{i:03d}_{sex}_scan.obj"] = {
            "sex": int(rng.integers(0, 2)),
            "reconstruction_error": {
                "mean": float(rng.uniform(0.1, 1.0)),
                "max": float(rng.integers(1, 4)) / 2.0},
        }
    with open(path, "w") as fp:
        json.dump(data, fp)
    return data


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    files = {"both": root / "inference.json", "f_only": root / "f.json"}
    data = _inference_json(files["both"])
    maxes = [r["reconstruction_error"]["max"] for r in data.values()]
    assert len(set(maxes)) < len(maxes)  # ties
    _inference_json(files["f_only"], sexes=("f",), n=4, seed=1)
    return files


def _root_script(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(REPO, name), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("which", ["both", "f_only"])
@pytest.mark.parametrize("flags", FLAGS, ids=" ".join)
def test_report_matches_root_script(results, which, flags, capsys,
                                    monkeypatch):
    argv = [str(results[which])] + flags
    want = _root_script("report.py", argv, capsys, monkeypatch)
    assert report.main(argv) == 0
    assert capsys.readouterr().out == want


def test_report_module_cli_byte_equal(results):
    """The -m entry point in a fresh process; the two host-only tools
    import neither torch nor matplotlib."""
    argv = [str(results["both"]), "-p", "-e", "-j"]
    run = lambda cmd: subprocess.run(cmd, capture_output=True, cwd=REPO,
                                     timeout=60, check=True).stdout
    want = run([sys.executable, "report.py"] + argv)
    assert run([sys.executable, "-m", "meshvae_tpu_torch.report"]
               + argv) == want
    code = ("import sys, meshvae_tpu_torch.report, "
            "meshvae_tpu_torch.plot_losses; print(sorted(m for m in "
            "('torch', 'matplotlib') if m in sys.modules))")
    assert run([sys.executable, "-c", code]).strip() == b"[]"


def _histories(root):
    """history1.json (5 epochs) and history2.json (3 epochs, the joint
    model's extra validation keys), in the port driver's schema."""
    rng = np.random.default_rng(2)
    paths = []
    for fold, (epochs, extra) in enumerate(((5, {}), (3, {
            "sup_accuracy": 0.5, "adv_accuracy": 0.25})), start=1):
        records, begin = [], 1000.0 * fold
        for epoch in range(1, epochs + 1):
            train = {k: float(rng.uniform(0, 2)) for k in
                     ("loss", "kld", "rec_loss", "accuracy", "error")}
            valid = dict(train, sex_change_success_rate=0.75, **extra)
            records.append(history_record(epoch, begin, 12.5 + epoch, train,
                                          valid, float(rng.uniform(0, 1))))
            begin += 30.0 + epoch
        path = os.path.join(root, f"history{fold}.json")
        with open(path, "w") as fp:
            json.dump(records, fp)
        paths.append(path)
    return paths


def _figure_content(figure):
    """What a plotLosses figure shows: per visible panel its y label,
    x limits, legend title and lines (label, style, x, y); the title and
    the text block."""
    panels = []
    for ax in figure.axes:
        if not ax.get_visible():
            continue
        panels.append({
            "label": ax.get_ylabel(), "xlim": tuple(ax.get_xlim()),
            "legend": ax.get_legend().get_title().get_text(),
            "lines": [(ln.get_label(), ln.get_linestyle(),
                       list(ln.get_xdata()), list(ln.get_ydata()))
                      for ln in ax.get_lines()]})
    title = figure._suptitle
    return (panels, title.get_text(),
            [t.get_text() for t in figure.texts if t is not title])


@pytest.mark.parametrize("n_files,config", [(1, False), (2, True)])
def test_plot_losses_matches_root_script(tmp_path, capsys, monkeypatch,
                                         n_files, config):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = _histories(str(tmp_path))[:n_files]
    argv = paths + (["-c", DEFAULT_CFG] if config else [])
    plt.close("all")
    _root_script("plotLosses.py", argv, capsys, monkeypatch)
    want_panels, want_title, want_texts = _figure_content(plt.gcf())
    plt.close("all")

    folds = plot_losses.load_histories(paths)
    panels = plot_losses.curves(folds)
    text = plot_losses.text_block(folds, DEFAULT_CFG if config else None)
    assert [(p["label"], tuple(map(float, p["xlim"])), p["label"],
             [(ln["label"], ln["style"], ln["x"], ln["y"])
              for ln in p["lines"]]) for p in panels] == \
        [(p["label"], p["xlim"], p["legend"], p["lines"])
         for p in want_panels]
    assert plot_losses.title(folds) == want_title
    assert [text] == want_texts
    if config:
        assert '"num_hidden": 512' in text
    figure = plot_losses.draw(panels, plot_losses.title(folds), text)
    assert _figure_content(figure) == (want_panels, want_title, want_texts)
    plt.close("all")


def test_plot_losses_cli_output_and_missing_matplotlib(tmp_path, capsys,
                                                       monkeypatch):
    """-o writes a PNG (Agg); with neither -o nor -d the text block and the
    curves are printed; without matplotlib -o exits 2 naming it."""
    paths = _histories(str(tmp_path))
    out = tmp_path / "out.png"
    assert plot_losses.main(paths + ["-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    import matplotlib.pyplot as plt
    plt.close("all")

    assert plot_losses.main(paths[:1] + ["-c", DEFAULT_CFG]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("Total training time : ")
    assert printed[1].startswith("Config : {")
    assert "loss training: 5 epochs, last" in printed[2]

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot_losses.main(paths + ["-o", str(tmp_path / "x.png")]) == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()
