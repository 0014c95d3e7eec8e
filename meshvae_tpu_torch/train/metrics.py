"""History records, the run log and the profiler hook (counterpart of
meshvae_tpu/train/metrics.py, one process): per-epoch ``history{fold}.json``
with the JAX package's schema, a plain-text log mirrored to stdout, and a
torch.profiler Chrome trace of the epochs in PROFILE_EPOCHS when the
config sets ``profile_dir``."""
from __future__ import annotations

import contextlib
import json
import os

import torch

# Epochs maybe_profile traces, as in the JAX package: epoch 1 pays the
# first-use costs (kernel builds, allocator growth); 2 is the first clean one.
PROFILE_EPOCHS = (2,)


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

    def __init__(self, path: str | None):
        """path None: a rank of a world that is not the primary, which
        prints and writes nothing."""
        self._fp = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fp = open(path, "w")

    def print(self, *args) -> None:
        if self._fp is None:
            return
        text = " ".join(str(a) for a in args)
        print(text, flush=True)
        print(text, file=self._fp, flush=True)

    def close(self) -> None:
        if self._fp is not None:
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


def is_profiled(profile_dir: str | None, epoch: int,
                profile_epochs: tuple = PROFILE_EPOCHS) -> bool:
    """True when maybe_profile traces this epoch."""
    return bool(profile_dir) and epoch in profile_epochs


def trace_path(profile_dir: str, fold: int, epoch: int) -> str:
    return os.path.join(profile_dir, f"fold{fold}_epoch{epoch}.trace.json")


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None, epoch: int, fold: int = 1,
                  profile_epochs: tuple = PROFILE_EPOCHS):
    """torch.profiler over the block for the selected epochs (CPU activity,
    and CUDA where a card is present), written as a Chrome trace to
    trace_path(profile_dir, fold, epoch); yields the profiler, or None
    when the epoch is not traced."""
    if not is_profiled(profile_dir, epoch, profile_epochs):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the block's device work is in the trace
    prof.export_chrome_trace(trace_path(profile_dir, fold, epoch))
