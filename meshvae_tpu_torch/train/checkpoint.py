"""Checkpoints of the port (counterpart of meshvae_tpu/train/checkpoint.py
with the port's own format).

``checkpoint_{fold}.pt`` holds the model's state_dict, the Adam state
(``torch.optim.Adam.state_dict()`` on the CPU, lr a float), ``epoch_num``,
``train_loss`` and ``val_loss``; a ``.meta.json`` beside it repeats the
three scalars. The initial-weights snapshot that every fold restarts from
is ``initial_weight.pt`` (a state_dict, as is every params file:
``save_params``, train/torch_import.py's output). Normalisation statistics
live in ``norm.npz``, written by ``data.MeshDataset``. ``load_model_state``
takes the model's weights from any of the three (a checkpoint, a JAX
checkpoint, a params file), for the readers that want weights alone.

``load_checkpoint`` also reads the JAX package's ``checkpoint_{fold}.msgpack``
(flax bytes of params, optax state, epoch_num, train_loss, val_loss;
meshvae_tpu/train/checkpoint.py) through the port's own decoder
(``flax_msgpack``) and returns the port's dict, so every reader of a ``.pt``
checkpoint reads a JAX one too: the params through
``models.vae.params_from_flax``, and the optax state
``inject_hyperparams(chain(add_decayed_weights, scale_by_adam,
scale_by_learning_rate))`` (meshvae_tpu/train/loop.py ``make_optimizer``)
as a ``torch.optim.Adam`` state dict: mu -> exp_avg, nu -> exp_avg_sq,
count -> step, hyperparams.learning_rate -> lr, names mapped as for the
params. Its param group holds only lr: the decay, the betas and eps are
constants of the optax chain, not of its state, so a loader keeps its own
optimizer's (the config's) for the keys the group lacks.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.vae import parameter_order, params_from_flax
from . import flax_msgpack


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file


def _to_cpu(state: dict) -> dict:
    return {k: v.detach().cpu() for k, v in state.items()}


def _optimizer_to_cpu(state: dict) -> dict:
    """An Adam state dict with its tensors on the CPU and each group's lr
    a float (on the card lr is a device tensor, train/loop.py
    make_optimizer)."""
    groups = [dict(g, lr=float(g["lr"])) for g in state.get("param_groups",
                                                           [])]
    return dict(state, param_groups=groups,
                state={i: _to_cpu(s) for i, s in state.get("state",
                                                            {}).items()})


def save_checkpoint(path: str, model_state: dict, optimizer_state: dict,
                    epoch: int, train_loss: float, val_loss: float) -> None:
    meta = {"epoch_num": int(epoch), "train_loss": float(train_loss),
            "val_loss": float(val_loss)}
    _save({"model": _to_cpu(model_state),
           "optimizer": _optimizer_to_cpu(optimizer_state), **meta}, path)
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
    (tensors on the CPU), from a port ``.pt`` or a JAX ``.msgpack``."""
    _require(path)
    if path.endswith(".msgpack"):
        return checkpoint_from_flax(flax_msgpack.load(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_from_flax(payload: dict) -> dict:
    """The JAX package's checkpoint tree (flax_msgpack.restore of its
    bytes) as the port's checkpoint dict."""
    model = params_from_flax(payload["params"])
    return {"model": model,
            "optimizer": adam_state_from_optax(payload["opt_state"], model),
            "epoch_num": int(payload["epoch_num"]),
            "train_loss": float(payload["train_loss"]),
            "val_loss": float(payload["val_loss"])}


def adam_state_from_optax(opt_state: dict, model: dict) -> dict:
    """optax's inject_hyperparams(chain(add_decayed_weights, scale_by_adam,
    scale_by_learning_rate)) state -> a torch.optim.Adam state dict over
    `model`'s parameters in the order its module registers them
    (models.vae.parameter_order: a MeshVAE, ChebGCN or JointMeshVAE)."""
    adam = opt_state["inner_state"]["1"]  # the chain's scale_by_adam
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    order = parameter_order(model)
    state = {i: {"step": step.clone(), "exp_avg": mu[name],
                 "exp_avg_sq": nu[name]} for i, name in enumerate(order)}
    lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
    return {"state": state,
            "param_groups": [{"lr": lr, "params": list(range(len(order)))}]}


def save_params(path: str, state_dict: dict) -> None:
    _save(_to_cpu(state_dict), path)


def load_params(path: str) -> dict:
    _require(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(path: str) -> dict:
    """The model's state_dict from a checkpoint (the port's ``.pt`` or a
    JAX ``.msgpack``) or from a params file (a bare state_dict)."""
    if path.endswith(".msgpack"):
        return load_checkpoint(path)["model"]
    payload = load_params(path)
    return payload["model"] if isinstance(payload.get("model"), dict) \
        else payload


def checkpoint_path(checkpoint_dir: str, fold: int) -> str:
    """checkpoint_{fold} naming, as the JAX package's (.pt here)."""
    return os.path.join(checkpoint_dir, f"checkpoint_{fold}.pt")


def find_checkpoint(checkpoint_dir: str, fold: int) -> str:
    """The fold's checkpoint: the port's checkpoint_{fold}.pt, else the JAX
    package's checkpoint_{fold}.msgpack."""
    pt = checkpoint_path(checkpoint_dir, fold)
    msgpack = os.path.join(checkpoint_dir, f"checkpoint_{fold}.msgpack")
    for path in (pt, msgpack):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no checkpoint for fold {fold}: neither {pt} nor {msgpack} exists "
        "— train first (python -m meshvae_tpu_torch.train -c <cfg> -t), or "
        "check the fold number and the config's checkpoint_dir")
