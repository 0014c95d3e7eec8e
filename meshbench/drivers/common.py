"""What the drivers share: the run's inputs from the seed, the program's
model with the benchmark's weights, the launch counters read as
differences, freeing the program before the reference runs, and the
reference's operators and model."""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import data
from ..reference import mesh as ref_mesh
from ..reference import model as ref_model


def template(cell) -> tuple[np.ndarray, np.ndarray]:
    """The template the configuration runs, worked out by the reference's
    frozen mesh code from the raw file (the data are made over it)."""
    m = cell.config["mesh"]
    return ref_mesh.template(os.path.join(cell.root, m["template"]),
                             int(m["subdivisions"]))


def inputs(cell, v: np.ndarray, n: int, device) -> dict:
    t = cell.traffic
    return data.synthetic_meshes(
        v, n, data.derive(cell.seed, "meshes"), device,
        deform_scale=float(t["deform_scale"]),
        class_scale=float(t["class_scale"]))


def program_model(cell, config: dict, device):
    """(model, ops, hier, template, weights): the program's model with the
    benchmark's weights, and those weights (a copy the program does not
    hold)."""
    from meshvae_tpu_torch.train.driver import build_model_and_ops

    model, ops, hier, tmpl = build_model_and_ops(config, device)
    specs = ref_model.param_specs(config, hier.levels[-1])
    weights = data.draw_weights(specs, data.derive(cell.seed, "weights"),
                                device)
    model.load_state_dict(weights)
    return model, ops, hier, tmpl, weights


def launches() -> dict:
    from meshvae_tpu_torch.ops import bsr_spmm

    return dict(bsr_spmm.LAUNCHES_BY_CALL)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def device_kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(torch.device(device)))
    return 0


def free(device) -> None:
    """Release what the dropped program objects held (graphs hold their
    memory pools until collected)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference(cell, v, f, device, precision: str = "fp32", hier=None):
    """(VAE, hierarchy) of the reference at `precision`, on `hier` where
    one is given, else on the hierarchy it works out from (v, f)."""
    ref_model.exact_fp32()
    if hier is None:
        hier = ref_mesh.hierarchy(v, f, cell.config["program"][
            "downsampling_factors"])
    ops = ref_model.Operators(hier, device, ref_model.Precision(precision))
    dtype = (torch.bfloat16 if cell.config["program"].get("compute_dtype")
             == "bfloat16" else torch.float32)
    return ref_model.VAE(cell.config["program"], ops,
                         ref_model.Precision(precision),
                         mask_dtype=dtype), hier


def clock() -> float:
    return time.perf_counter()
