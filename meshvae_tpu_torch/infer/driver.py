"""Batch inference (counterpart of meshvae_tpu/infer/driver.py).

``InferenceEngine.step`` is the counterpart of ``_step_impl``: predict the
label with the classifier head, reconstruct conditioned on the predicted
label and decode the label-swapped counterfactual from the same latent as
ONE decoder pass at batch 2B, map both back to the original pose, and score
the reconstruction when the original is given. The encoder runs once.

``InferenceEngine.run_dataset`` is the counterpart of ``_scan_impl``: every
batch of a loader runs on the device, the ground truth is recomputed there
from x, and the per-mesh pred / err_mean / err_max stay on the device until
one packed [S, 3, B] pull at the end (the mesh stacks too, only when asked
for).

``run_inference`` is the body of ``python -m meshvae_tpu_torch.infer``, the
paper's sex-change experiment: for every mesh of the data directory
(labels unknown) it writes ``pred.json`` (path -> str(pred)),
``error_list.json`` (path -> mean error, 4 decimals), ``inference.json``
(name -> {"sex", "reconstruction_error": {"mean", "max"}}) and the
``sex_change/`` triples ``{stem}_recon.obj``, ``{stem}_gt.obj`` and
``{stem}.obj`` (the counterfactual), with the JAX package's names, schemas
and key order. The JAX engine's device-mesh sharding and multi-host writer
have no counterpart here (ROADMAP: distribution).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import BatchIterator, MeshDataset, list_meshes
from ..device import resolve_device
from ..mesh.io import save_obj
from ..mesh.procrustes import apply_inverse_similarity
from ..models.operators import ModelOperators


class InferenceEngine:
    """model: an eval-mode MeshVAE; ops: ModelOperators on the model's
    device."""

    def __init__(self, model, ops: ModelOperators):
        self.model = model
        self.ops = ops
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def step(self, batch: dict, norm_mean: torch.Tensor,
             norm_std: torch.Tensor) -> dict:
        """batch: x [B, N, 3] normalized aligned vertices, r [B, 3, 3],
        s [B], m [B, 1, 3] (inverse similarity), optionally original
        [B, N, 3]. Returns pred [B], recon_orig / oppo_orig [B, N, 3] and,
        with original, err_mean / err_max [B]."""
        model, ops = self.model, self.ops
        x = batch["x"]
        h = model.encode(x, ops)
        y_hat = model.classify(h)
        pred = torch.argmax(y_hat, dim=-1)
        y = F.one_hot(pred, y_hat.shape[-1]).to(x.dtype)
        mu = model.z_mean(torch.cat([y, h], dim=-1))
        b = x.shape[0]
        both = model.sample(torch.cat([y, 1.0 - y], dim=0),
                            torch.cat([mu, mu], dim=0), ops)
        recon, recon_oppo = both[:b], both[b:]

        def to_orig(t):
            return apply_inverse_similarity(t * norm_std + norm_mean,
                                            batch["r"], batch["s"], batch["m"])

        out = {"pred": pred, "recon_orig": to_orig(recon),
               "oppo_orig": to_orig(recon_oppo)}
        if "original" in batch:
            err = torch.sqrt(torch.sum(
                (out["recon_orig"] - batch["original"]) ** 2, dim=-1))
            out["err_mean"] = err.mean(dim=-1)
            out["err_max"] = err.max(dim=-1).values
        return out

    @torch.inference_mode()
    def run_dataset(self, loader, norm_mean: torch.Tensor,
                    norm_std: torch.Tensor, collect_meshes: bool = True):
        """Every batch of `loader` (data.BatchIterator host dicts) through
        ``step`` on the device, the original pose recomputed there from x
        (the dataset's original is aligned @ R * s + m with aligned =
        x * std + mean; equal within fp32 round-off). Returns the host
        arrays packed [S, 3, B] (pred, err_mean, err_max, pulled once),
        mask and index [S, B] and, with collect_meshes, recon_orig and
        oppo_orig [S, B, N, 3]; None for an empty loader."""
        packed, masks, index = [], [], []
        meshes = {"recon_orig": [], "oppo_orig": []}
        for host in loader:
            batch = {k: torch.as_tensor(np.asarray(host[k]),
                                        dtype=torch.float32).to(self.device)
                     for k in ("x", "r", "s", "m")}
            batch["original"] = apply_inverse_similarity(
                batch["x"] * norm_std + norm_mean, batch["r"], batch["s"],
                batch["m"])
            out = self.step(batch, norm_mean, norm_std)
            packed.append(torch.stack([out["pred"].to(torch.float32),
                                       out["err_mean"], out["err_max"]]))
            if collect_meshes:
                for k in meshes:
                    meshes[k].append(out[k])
            masks.append(np.asarray(host["mask"]))
            index.append(np.asarray(host["index"]))
        if not packed:
            return None
        res = {"packed": torch.stack(packed).cpu().numpy(),  # ONE pull
               "mask": np.stack(masks), "index": np.stack(index)}
        if collect_meshes:
            res.update({k: torch.stack(v).cpu().numpy()
                        for k, v in meshes.items()})
        return res


def run_inference(model, ops: ModelOperators, output_path: str, mean, std,
                  config: dict, template, batch_size: int, faces,
                  write_pred: bool = True, write_error_list: bool = True,
                  write_inference: bool = True, save_meshes: bool = True,
                  engine: InferenceEngine | None = None,
                  device="cuda") -> dict:
    """The sex-change run over config["root_dir"] (see the module doc);
    `model` and `ops` live on `device`, the normalisation is `mean` /
    `std` [N, 3] (the MeshDataset reads the same statistics from
    checkpoint_dir/norm.npz). Returns the inference.json dict."""
    device = resolve_device(device)
    dataset_index, labels = list_meshes(config, sex_from_filename=False)
    dataset = MeshDataset(dataset_index, config, labels,
                          template=np.asarray(template), dtype="test")
    loader = BatchIterator(dataset, batch_size, shuffle=False)
    if engine is None:
        engine = InferenceEngine(model, ops)
    mean_dev, std_dev = (torch.as_tensor(np.asarray(a, np.float32),
                                         device=device) for a in (mean, std))

    results: dict[str, dict] = {}
    pred_sex: dict[str, str] = {}
    error_dict: dict[str, str] = {}
    mesh_dir = os.path.join(output_path, "sex_change")
    if save_meshes:
        os.makedirs(mesh_dir, exist_ok=True)
    os.makedirs(output_path, exist_ok=True)

    outs = engine.run_dataset(loader, mean_dev, std_dev,
                              collect_meshes=save_meshes)
    if outs is not None:
        packed, mask = outs["packed"], outs["mask"] > 0
        for s_i in range(mask.shape[0]):
            for b_i in np.nonzero(mask[s_i])[0]:  # padded tail rows skipped
                ds_idx = int(outs["index"][s_i, b_i])
                pred = int(packed[s_i, 0, b_i])
                e_mean = float(packed[s_i, 1, b_i])
                e_max = float(packed[s_i, 2, b_i])
                path = dataset.filenames[ds_idx]
                name = path.split("/").pop()
                results[name] = {
                    "sex": pred,
                    "reconstruction_error": {"mean": e_mean, "max": e_max},
                }
                pred_sex[path] = str(pred)
                error_dict[path] = format(e_mean, ".4f")
                if save_meshes:
                    stem = name.split(".")[0]
                    save_obj(os.path.join(mesh_dir, stem + "_recon.obj"),
                             outs["recon_orig"][s_i, b_i], faces)
                    save_obj(os.path.join(mesh_dir, stem + "_gt.obj"),
                             dataset.original[ds_idx], faces)
                    save_obj(os.path.join(mesh_dir, stem + ".obj"),
                             outs["oppo_orig"][s_i, b_i], faces)

    for wanted, name, obj in ((write_pred, "pred.json", pred_sex),
                              (write_error_list, "error_list.json",
                               error_dict),
                              (write_inference, "inference.json", results)):
        if wanted:
            with open(os.path.join(output_path, name), "w") as fp:
                json.dump(obj, fp)
    return results
