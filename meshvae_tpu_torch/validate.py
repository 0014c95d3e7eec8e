"""Config preflight of the distribution keys (counterpart of the dp / sp /
batch checks of meshvae_tpu/validate.py:60-90): fail fast, before any
process is started or any device is touched.

  * data_parallel and seq_parallel are at least 1;
  * batch_size divides evenly over data_parallel (each rank runs B / dp
    rows of every batch);
  * on CUDA every local rank has a card of its own: world = dp * sp local
    ranks (multihost: the LOCAL_WORLD_SIZE a launcher sets, else 1) must
    not exceed torch.cuda.device_count(). Ranks that share a card run only
    in tests and in the card's smoke run, which build their worlds
    directly;
  * multihost with an explicit coordinator: num_processes = dp * sp.

The JAX package's ELL envelope (:92-108) waits with cheb_method = ell
(ROADMAP.md section 1).
"""
from __future__ import annotations

import os

import torch


class ConfigError(ValueError):
    """A config that cannot run in this environment."""


def validate_config(config: dict, device="cuda",
                    n_devices: int | None = None) -> None:
    """Raise ConfigError for a config that cannot run on `device`;
    n_devices overrides torch.cuda.device_count() (tests)."""
    dp = int(config.get("data_parallel", 1))
    sp = int(config.get("seq_parallel", 1))
    batch_size = int(config.get("batch_size", 16))
    if dp < 1 or sp < 1:
        raise ConfigError(
            f"data_parallel ({dp}) and seq_parallel ({sp}) must be >= 1")
    if batch_size % dp:
        raise ConfigError(
            f"batch_size ({batch_size}) must be divisible by data_parallel "
            f"({dp}): each rank runs an equal slice of every batch.")
    multihost = bool(config.get("multihost", False))
    if (multihost and config.get("coordinator_address")
            and int(config.get("num_processes") or 0) != dp * sp):
        raise ConfigError(
            f"multihost: num_processes ({config.get('num_processes')}) must "
            f"equal data_parallel x seq_parallel = {dp * sp} (one process "
            f"per rank)")
    if torch.device(device).type != "cuda":
        return
    local = (int(os.environ.get("LOCAL_WORLD_SIZE", 1)) if multihost
             else dp * sp)
    cards = torch.cuda.device_count() if n_devices is None else n_devices
    if local > cards:
        raise ConfigError(
            f"config asks for {local} local rank(s) (data_parallel x "
            f"seq_parallel = {dp * sp}{', multihost' if multihost else ''}) "
            f"but this host has {cards} CUDA card(s); each rank needs a card "
            f"of its own. Lower data_parallel / seq_parallel, run with "
            f"--device cpu, or spread the ranks over hosts (multihost = "
            f"true).")
