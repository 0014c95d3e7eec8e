"""History records and the run log (counterpart of
meshvae_tpu/train/metrics.py, one process): per-epoch ``history{fold}.json``
with the JAX package's schema, and a plain-text log mirrored to stdout."""
from __future__ import annotations

import json
import os


def history_record(epoch: int, begin: float, duration: float,
                   train: dict, valid: dict, mean_val_error: float) -> dict:
    """One epoch's record. `begin` is the epoch's start and `finalized`
    (= begin + duration) the moment its metrics were read back."""
    record = {
        "epoch": epoch,
        "begin": begin,
        "duration": duration,
        "finalized": begin + duration,
        "training": {
            "loss": train["loss"],
            "kld": train["kld"],
            "reconstruction_loss": train["rec_loss"],
            "accuracy": train["accuracy"],
            "error": train["error"],
        },
        "validation": {
            "loss": valid["loss"],
            "kld": valid["kld"],
            "reconstruction_loss": valid["rec_loss"],
            "accuracy": valid["accuracy"],
            "error": mean_val_error,
            "sex_change_success_rate": valid["sex_change_success_rate"],
        },
    }
    known = {"loss", "kld", "rec_loss", "accuracy", "error", "count",
             "sex_change_success_rate"}
    for key, value in valid.items():
        if key not in known:
            record["validation"][key] = value
    return record


def write_history(checkpoint_dir: str, fold: int, history: list[dict]) -> None:
    with open(os.path.join(checkpoint_dir, f"history{fold}.json"), "w") as fp:
        json.dump(history, fp)


class RunLog:
    """Text log: every line goes to stdout and to the file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fp = open(path, "w")

    def print(self, *args) -> None:
        text = " ".join(str(a) for a in args)
        print(text, flush=True)
        print(text, file=self._fp, flush=True)

    def close(self) -> None:
        self._fp.close()


def epoch_line(epoch: int, train: dict, valid: dict,
               mean_val_error: float) -> str:
    return (
        "Epoch {}, train loss {}(kld {}, recon loss {}, train acc {}) || "
        "valid loss {}(error {}, rec_loss {}, valid acc {}, sex change acc {})"
    ).format(epoch, train["loss"], train["kld"], train["rec_loss"],
             train["accuracy"], valid["loss"], mean_val_error,
             valid["rec_loss"], valid["accuracy"],
             valid["sex_change_success_rate"])
