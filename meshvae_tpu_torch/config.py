"""Config system (counterpart of meshvae_tpu/config.py): INI-compatible flat
config with the reference's key names.

Keys are looked up across all sections, missing keys fall back to typed
defaults, and unknown keys are preserved as strings. The schema is the JAX
package's, so the same .cfg files parse to the same dict; keys that only the
JAX package reads (data_parallel, multihost, ...) are carried and ignored.
"""
from __future__ import annotations

import configparser
import json
import os
from typing import Any, Callable


def parse_bool(value) -> bool:
    """A config flag: a bool, or "1"/"true"/"yes"/"on" (any case) for True
    and anything else for False."""
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("1", "true", "yes", "on")


def _csv(cast: Callable):
    def parse(value: str):
        return [cast(x) for x in str(value).split(",")]
    return parse


# key -> (parser, default)
_SCHEMA: dict[str, tuple[Callable, Any]] = {
    "root_dir": (str, ""),
    "checkpoint_dir": (str, "./results/exp/"),
    "template": (str, "./template/template5k.obj"),
    "error_file": (str, ""),
    "log_file": (str, "log.txt"),
    "type": (str, "cheb_VAE"),
    "num_classes": (int, 2),
    "num_style": (int, 16),
    "model": (str, "optimal_sigma_VAE"),
    "folds": (int, 5),
    "test_size": (float, 0.3),
    "random_seeds": (int, 666),
    "checkpoint_file": (str, ""),
    "n_layers": (int, 4),
    "num_hidden": (int, 512),
    "downsampling_factors": (_csv(int), [4, 4, 4, 4]),
    "num_conv_filters": (_csv(int), [16, 16, 16, 32, 32]),
    "workers_thread": (int, 6),
    "polygon_order": (_csv(int), [6, 6, 6, 6, 6]),
    "optimizer": (str, "adam"),
    "batch_size": (int, 16),
    "learning_rate": (float, 1e-3),
    "learning_rates": (_csv(float), [1e-4, 5e-5]),
    "learning_rates_epochs": (_csv(float), [500, 10000]),
    "learning_rate_decay": (float, 0.99),
    "weight_decay": (float, 5e-4),
    "dropout": (float, 0.2),
    "epoch": (int, 300),
    "latent_split": (int, 2),
    "sup_weight": (float, 1.0),
    "adv_weight": (float, 0.1),
    "cls_weight": (float, 1.0),
    "cheb_method": (str, "dense"),       # dense | ell | pallas (the kernel)
    "pool_method": (str, "gather"),      # gather | dense
    "compute_dtype": (str, "float32"),   # float32 | bfloat16
    # "" | high | highest on float32; bfloat16 clamps every value to
    # default (ops/cheb.py resolve_precision)
    "matmul_precision": (str, ""),
    "final_conv_adjacency": (str, "reference_quirk"),  # reference_quirk | finest
    "hierarchy_mode": (str, "fast"),     # fast | reference (bit-exact QSlim)
    "data_parallel": (int, 1),
    "seq_parallel": (int, 1),
    "multihost": (parse_bool, False),
    "coordinator_address": (str, ""),
    "num_processes": (int, 0),
    "process_id": (int, -1),
    "scan_epoch": (parse_bool, True),
    "serve_wire_dtype": (str, "float16"),  # serving-chunk x dtype on the wire
    "hierarchy_cache_dir": (str, ""),
    "profile_dir": (str, ""),
    "halt_on_nonfinite": (parse_bool, True),
}


def read_config(fname: str) -> dict:
    """INI file -> flat typed dict (reference-compatible key set + defaults)."""
    if not os.path.exists(fname):
        raise FileNotFoundError(f"Config not found: {fname}")

    parser = configparser.RawConfigParser()
    parser.read(fname)

    raw: dict[str, str] = {}
    for section in parser.sections():
        for key, value in parser.items(section):
            raw[key] = value

    config: dict[str, Any] = {}
    for key, (parse, default) in _SCHEMA.items():
        if key in raw and str(raw[key]).strip() != "":
            config[key] = parse(raw[key])
        else:
            config[key] = default
    # pass through unknown keys as raw strings
    for key, value in raw.items():
        if key not in config:
            config[key] = value

    # reference quirk: log_file is resolved relative to checkpoint_dir
    config["log_file"] = os.path.join(config["checkpoint_dir"], config["log_file"])
    return config


def default_config() -> dict:
    config = {key: default for key, (_, default) in _SCHEMA.items()}
    config["log_file"] = os.path.join(config["checkpoint_dir"], config["log_file"])
    return config


def apply_overrides(config: dict, overrides: list[tuple[str, str]] | None) -> dict:
    """CLI `-p key value` overrides with JSON coercion for non-string
    targets; a flag also takes the config file's spellings (parse_bool:
    ``-p scan_epoch False``)."""
    if not overrides:
        return config
    for key, value in overrides:
        current = config.get(key)
        if isinstance(current, bool):
            value = parse_bool(value)
        elif current is not None and not isinstance(current, str):
            value = json.loads(value)
        config[key] = value
    return config
