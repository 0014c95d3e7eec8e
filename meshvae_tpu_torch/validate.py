"""Config preflight (counterpart of meshvae_tpu/validate.py): fail fast,
before any process is started or any device is touched.

  * data_parallel and seq_parallel are at least 1;
  * batch_size divides evenly over data_parallel (each rank runs B / dp
    rows of every batch);
  * on CUDA every local rank has a card of its own: world = dp * sp local
    ranks (multihost: the LOCAL_WORLD_SIZE a launcher sets, else 1) must
    not exceed torch.cuda.device_count(). Ranks that share a card run only
    in tests and in the card's smoke run, which build their worlds
    directly;
  * multihost with an explicit coordinator: num_processes = dp * sp;
  * cheb_method = ell on CUDA, once the level-0 vertex count and largest
    degree are known (``level0``): the level-0 convs' memory
    (``ell_step_bytes``, per card: under seq_parallel the rank's rows of
    level 0 and the all-gathered operand) must fit on the card. The JAX
    package's envelope
    (meshvae_tpu/validate.py:25-39) is a TPU crash boundary in
    batch-vertices; on the H100 the limit is memory, so the port holds a
    byte count instead. The count is a lower bound of the step's peak
    (coarser levels, pools, heads and Adam come on top), so a refused
    config cannot fit, and one that passes may still run out of memory.
"""
from __future__ import annotations

import os

import torch

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def level0_shape(adjacency) -> tuple[int, int]:
    """(vertices, largest degree) of a level's Laplacian, the width of its
    neighbour lists under cheb_method = ell (ops/graph.py _to_ell)."""
    import numpy as np

    from .ops.graph import normalized_neg_adjacency

    lap = normalized_neg_adjacency(adjacency)
    return lap.shape[0], int(np.diff(lap.indptr).max(initial=0))


def level0_convs(config: dict, num_features: int = 3) -> list[tuple]:
    """(rows per batch row, K, F_in, F_out) of every Chebyshev conv at level
    0 of the model the config builds (models/vae.py, models/joint.py): the
    encoder's first conv; the decoder's last block conv (at 2 rows per
    batch row in the joint model, which decodes the true and the opposite
    label in one pass); the final conv when final_conv_adjacency is
    "finest" (the reference quirk runs it on the coarsest corner); and the
    joint model's GCN conv over the 2 * num_features difference
    channels."""
    chain = [num_features] + [int(f) for f in config["num_conv_filters"]]
    k = [int(o) for o in config["polygon_order"]]
    n_layers = int(config["n_layers"])
    joint = config.get("type") == "joint_VAE"
    dec_rows = 2 if joint else 1
    convs = [(1, k[0], chain[0], chain[1]),
             (dec_rows, k[n_layers - 1], chain[-n_layers],
              chain[-n_layers - 1])]
    if config.get("final_conv_adjacency", "reference_quirk") == "finest":
        convs.append((dec_rows, k[len(chain) - 2], chain[1], chain[0]))
    if joint:
        convs.append((1, k[0], 2 * num_features, chain[1]))
    return convs


def ell_step_bytes(batch: int, n: int, max_degree: int, convs: list,
                   itemsize: int, sp: int = 1) -> dict:
    """Bytes on one card of one cheb_method = ell train step at level 0 (n
    vertices, neighbour lists of max_degree), for `convs` as level0_convs
    gives them, B = `batch` rows per card and operands of `itemsize`
    bytes. Under seq_parallel (sp > 1) a card holds the rank's R rows of
    level 0 (ops/bsr_shard.py RowShard.for_level: 128 * ceil(n_pad /
    (sp * 128)), n_pad the block-padded row count), else R = N:

      gather    = rows * B * R * D * F_in * s: one propagation's [B, R, D,
                  F] neighbour gather (ops/cheb.py propagate_ell);
      transient = 2 * max gather (+ under sp the all-gathered [B, sp * R,
                  F_in] operand of that propagation): the gather and one
                  copy of it for the reduction over D, in the forward, and
                  the same two in the backward; one propagation's at a
                  time, and nothing of them is kept: autograd keeps only
                  the operator's own idx and w (no bytes of its own);
      kept      = sum of rows * B * R * (K * F_in + F_out) * s: what each
                  conv keeps for its backward, the concatenated basis
                  [B, R, K * F_in] (for dW) and its output (for the ReLU).

    total = kept + transient, the level-0 share of the step's peak."""
    from .ops.bsr_shard import RowShard

    local = n if sp == 1 else RowShard.for_level(n, sp, 0, None).rows_local
    gathers = [r * batch * local * max_degree * f_in * itemsize
               for r, _, f_in, _ in convs]
    operands = [0 if sp == 1 else r * batch * sp * local * f_in * itemsize
                for r, _, f_in, _ in convs]
    kept = sum(r * batch * local * (k * f_in + f_out) * itemsize
               for r, k, f_in, f_out in convs)
    transient = max(2 * g + o for g, o in zip(gathers, operands))
    return {"gather": max(gathers), "transient": transient, "kept": kept,
            "total": kept + transient}


class ConfigError(ValueError):
    """A config that cannot run in this environment."""


def validate_config(config: dict, device="cuda",
                    n_devices: int | None = None,
                    level0: tuple[int, int] | None = None,
                    num_features: int = 3,
                    card_bytes: int | None = None) -> None:
    """Raise ConfigError for a config that cannot run on `device`;
    n_devices overrides torch.cuda.device_count() and card_bytes the card's
    memory (tests). level0 = (vertices, largest degree) of the level-0
    Laplacian (level0_shape), once the hierarchy is known, turns on the
    ELL memory check."""
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
    if str(config.get("cheb_method", "dense")) == "ell" and level0:
        _check_ell_memory(config, device, level0, num_features, dp, sp,
                          card_bytes)


def _check_ell_memory(config, device, level0, num_features, dp, sp,
                      card_bytes):
    n, degree = level0
    batch = int(config.get("batch_size", 16)) // dp
    dtype = str(config.get("compute_dtype", "float32") or "float32")
    need = ell_step_bytes(batch, n, degree,
                          level0_convs(config, num_features),
                          _DTYPE_BYTES[dtype], sp)["total"]
    if card_bytes is None:
        card_bytes = torch.cuda.get_device_properties(
            torch.device(device)).total_memory
    if need > card_bytes:
        fits = batch * card_bytes // need
        raise ConfigError(
            f"cheb_method = ell at batch {batch} per card x {n} vertices "
            f"(seq_parallel {sp}, largest degree {degree}, {dtype}) needs "
            f"at least "
            f"{need / 2**30:.1f} GiB at level 0 alone (validate."
            f"ell_step_bytes: the convs' kept bases and outputs plus the "
            f"transient [B, N, D, F] neighbour gather), more than the "
            f"card's {card_bytes / 2**30:.1f} GiB. Use cheb_method = pallas "
            f"(the block-sparse kernel keeps no gather), or lower "
            f"batch_size to at most {fits} per card (raise data_parallel, "
            f"or seq_parallel to split the vertices, to spread it).")
