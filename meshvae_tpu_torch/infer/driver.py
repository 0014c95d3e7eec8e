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
and key order.

In a world (``dist``, a parallel.World), as the JAX engine under a mesh:
each rank runs its dp rows of every batch, with the operators row-sharded
over sp in the row layout (x, the normalisation, the activations at
row-sharded levels and the meshes are the rank's vertex rows; the error
mean and max reduce over sp); the packed results and the mesh stacks are
all-gathered over dp, the meshes over sp first (parallel.fetch), and only
the primary rank writes files.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import BatchIterator, MeshDataset, list_meshes
from ..device import resolve_device
from ..mesh.io import save_obj
from ..mesh.procrustes import apply_inverse_similarity
from ..models.operators import ModelOperators
from ..parallel.sharding import (fetch, is_primary, shard_batch,
                                 shard_operators, vertex_max, vertex_mean,
                                 vertex_rows)


class InferenceEngine:
    """model: an eval-mode MeshVAE or JointMeshVAE (driven through encode,
    classify, posterior_mean and sample, in its compute dtype); ops:
    ModelOperators on the model's device; dist: a parallel.World, or None
    in one process."""

    def __init__(self, model, ops: ModelOperators, dist=None):
        self.model = model
        self.ops = shard_operators(ops, dist)
        self.dist = dist
        self.vertex_shard = vertex_rows(self.ops, dist)
        self.device = next(model.parameters()).device

    def norm_to_device(self, norm_mean, norm_std, device) -> tuple:
        """The normalisation [N, 3] on `device` as the steps read it: the
        rank's vertex rows in the row layout."""
        out = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                    for a in (norm_mean, norm_std))
        if self.vertex_shard is None:
            return out
        return tuple(self.vertex_shard.local(t, dim=0) for t in out)

    @torch.inference_mode()
    def step(self, batch: dict, norm_mean: torch.Tensor,
             norm_std: torch.Tensor) -> dict:
        """batch: x [B, N, 3] normalized aligned vertices, r [B, 3, 3],
        s [B], m [B, 1, 3] (inverse similarity), optionally original
        [B, N, 3]. Returns pred [B], recon_orig / oppo_orig [B, N, 3] and,
        with original, err_mean / err_max [B]."""
        return self._step_impl(batch, norm_mean, norm_std)

    def _step_impl(self, batch: dict, norm_mean: torch.Tensor,
                   norm_std: torch.Tensor) -> dict:
        """``step`` outside inference mode, as torch.export traces it
        (infer/export.py): no host sync and no branch on a tensor's
        value."""
        model, ops = self.model, self.ops
        x = batch["x"]
        h = model.encode(x, ops)
        y_hat = model.classify(h)
        pred = torch.argmax(y_hat, dim=-1)
        y = F.one_hot(pred, y_hat.shape[-1]).to(x.dtype)
        mu = model.posterior_mean(torch.cat([y, h], dim=-1))
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
            out["err_mean"] = vertex_mean(err, self.vertex_shard)
            out["err_max"] = vertex_max(err, self.vertex_shard)
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
        oppo_orig [S, B, N, 3]; None for an empty loader. In a world each
        rank runs its dp rows and gets every rank's results."""
        packed, masks, index = [], [], []
        meshes = {"recon_orig": [], "oppo_orig": []}
        for host in loader:
            rows = shard_batch({k: host[k] for k in ("x", "r", "s", "m")},
                               self.dist, self.vertex_shard)
            batch = {k: torch.as_tensor(np.asarray(rows[k]),
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
        res = {"packed": fetch(torch.stack(packed), self.dist, dim=2),
               "mask": np.stack(masks), "index": np.stack(index)}
        if collect_meshes:
            res.update({k: fetch(torch.stack(v), self.dist, dim=1,
                                 rows=self.vertex_shard)
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
    checkpoint_dir/norm.npz). Returns the inference.json dict. In a world
    (the engine's dist) every rank runs and only the primary writes."""
    device = resolve_device(device)
    dataset_index, labels = list_meshes(config, sex_from_filename=False)
    dataset = MeshDataset(dataset_index, config, labels,
                          template=np.asarray(template), dtype="test")
    loader = BatchIterator(dataset, batch_size, shuffle=False)
    if engine is None:
        engine = InferenceEngine(model, ops)
    write = is_primary(engine.dist)
    mean_dev, std_dev = engine.norm_to_device(mean, std, device)

    results: dict[str, dict] = {}
    pred_sex: dict[str, str] = {}
    error_dict: dict[str, str] = {}
    mesh_dir = os.path.join(output_path, "sex_change")
    if write and save_meshes:
        os.makedirs(mesh_dir, exist_ok=True)
    if write:
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
                if write and save_meshes:
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
        if wanted and write:
            with open(os.path.join(output_path, name), "w") as fp:
                json.dump(obj, fp)
    return results


def run_cli(world, args, config) -> int:
    """The body of ``python -m meshvae_tpu_torch.infer`` on one rank
    (world None: the only process): `args` are the CLI's parsed arguments,
    `config` the resolved config. A module-level function here, so that
    the spawned ranks of a local world can import it."""
    from ..train.checkpoint import find_checkpoint, load_model_state
    from ..train.driver import build_model_and_ops
    from .serve import MeshServer

    device = world.device if world is not None else resolve_device(
        args.device)
    model, ops, _, template = build_model_and_ops(config, device)
    ckpt = find_checkpoint(config["checkpoint_dir"], args.model)
    model.load_state_dict(load_model_state(ckpt))
    with np.load(os.path.join(config["checkpoint_dir"], "norm.npz")) as norm:
        mean = norm["mean"].astype(np.float32)
        std = norm["std"].astype(np.float32)
    batch_size = int(config["batch_size"])

    if args.export or args.export_serve:
        return export_cli(args, config, model, ops, mean, std,
                          template.v.shape[0])

    if args.serve:
        server = MeshServer(
            model, ops, mean, std, template=template.v, faces=template.f,
            batch_size=batch_size, output_path=args.output_path,
            save_meshes=not args.no_meshes,
            wire_dtype=np.dtype(config.get("serve_wire_dtype", "float16")),
            device=device, dist=world)
        try:
            sec = server.warmup()
            if server.primary:
                print(json.dumps({"ready": True, "warmup_sec": round(sec, 2),
                                  "batch_size": server.batch_size}),
                      flush=True)
            server.serve_forever(sys.stdin, sys.stdout)
        finally:
            server.close()
        return 0

    any_selected = args.pred or args.error_list or args.inference
    run_inference(
        model, ops, args.output_path, mean, std, config,
        template=template.v, batch_size=batch_size, faces=template.f,
        write_pred=args.pred or not any_selected,
        write_error_list=args.error_list or not any_selected,
        write_inference=args.inference or not any_selected,
        save_meshes=not args.no_meshes,
        engine=InferenceEngine(model, ops, dist=world), device=device)
    return 0


def export_cli(args, config, model, ops, mean, std, num_vertices: int) -> int:
    """--export / --export-serve of ``python -m meshvae_tpu_torch.infer``:
    the artifacts of the loaded model for args.export_platforms."""
    from .export import (export_packed_serving_step, export_serving_step,
                         save_serving_artifact)

    batch_size = int(config["batch_size"])
    platforms = args.export_platforms
    if args.export:
        data = export_serving_step(model, ops, mean, std, batch_size,
                                   num_vertices, platforms=platforms)
        save_serving_artifact(args.export, data)
        print(f"serving artifact written to {args.export} "
              f"({len(data) / 1e6:.1f} MB)")
    if args.export_serve:
        wire = getattr(torch, config.get("serve_wire_dtype", "float16"))
        data = export_packed_serving_step(
            model, ops, mean, std, batch_size, num_vertices,
            collect_meshes=not args.no_meshes, wire_dtype=wire,
            platforms=platforms)
        save_serving_artifact(args.export_serve, data)
        print(f"serve artifact written to {args.export_serve} "
              f"({len(data) / 1e6:.1f} MB)")
    return 0


def serve_artifact(args, config) -> int:
    """``--serve --artifact PATH``: a MeshServer on an --export-serve
    artifact, in one process. It reads the config, the template and
    norm.npz, and builds no hierarchy, operators or model."""
    from ..mesh.io import load_obj
    from ..tools.make_scaled_template import ensure_template
    from .export import load_serving_step
    from .serve import MeshServer

    device = resolve_device(args.device)
    ensure_template(config["template"])
    template = load_obj(config["template"])
    with np.load(os.path.join(config["checkpoint_dir"], "norm.npz")) as norm:
        mean = norm["mean"].astype(np.float32)
        std = norm["std"].astype(np.float32)
    server = MeshServer(
        None, None, mean, std, template=template.v, faces=template.f,
        batch_size=int(config["batch_size"]), output_path=args.output_path,
        save_meshes=not args.no_meshes,
        wire_dtype=np.dtype(config.get("serve_wire_dtype", "float16")),
        device=device, serving_step=load_serving_step(args.artifact, device))
    try:
        sec = server.warmup()
        print(json.dumps({"ready": True, "warmup_sec": round(sec, 2),
                          "batch_size": server.batch_size,
                          "artifact": args.artifact}), flush=True)
        server.serve_forever(sys.stdin, sys.stdout)
    finally:
        server.close()
    return 0
