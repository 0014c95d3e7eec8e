"""Checkpoints of the port (counterpart of meshvae_tpu/train/checkpoint.py
with the port's own format).

``checkpoint_{fold}.pt`` holds the model's state_dict, the Adam state
(``torch.optim.Adam.state_dict()``), ``epoch_num``, ``train_loss`` and
``val_loss``; a ``.meta.json`` beside it repeats the three scalars. The
initial-weights snapshot that every fold restarts from is
``initial_weight.pt`` (a state_dict). Normalisation statistics live in
``norm.npz``, written by ``data.MeshDataset``. The JAX package's flax
``.msgpack`` checkpoints are not read by the port yet.
"""
from __future__ import annotations

import json
import os

import torch


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file


def _to_cpu(state: dict) -> dict:
    return {k: v.detach().cpu() for k, v in state.items()}


def save_checkpoint(path: str, model_state: dict, optimizer_state: dict,
                    epoch: int, train_loss: float, val_loss: float) -> None:
    meta = {"epoch_num": int(epoch), "train_loss": float(train_loss),
            "val_loss": float(val_loss)}
    _save({"model": _to_cpu(model_state), "optimizer": optimizer_state,
           **meta}, path)
    with open(path + ".meta.json", "w") as fp:
        json.dump(meta, fp)


def _require(path: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint not found: {path} — train first (python -m "
            "meshvae_tpu_torch.train -c <cfg> -t), or check the config's "
            "checkpoint_dir")


def load_checkpoint(path: str) -> dict:
    """The saved dict: model, optimizer, epoch_num, train_loss, val_loss
    (tensors on the CPU)."""
    _require(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_params(path: str, state_dict: dict) -> None:
    _save(_to_cpu(state_dict), path)


def load_params(path: str) -> dict:
    _require(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_path(checkpoint_dir: str, fold: int) -> str:
    """checkpoint_{fold} naming, as the JAX package's (.pt here)."""
    return os.path.join(checkpoint_dir, f"checkpoint_{fold}.pt")
