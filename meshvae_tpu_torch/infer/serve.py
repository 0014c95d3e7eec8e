"""Warm-engine serving loop (counterpart of meshvae_tpu/infer/serve.py).

Protocol: line-oriented stdio.

  stdin   one request per line — a path to an ``.obj`` mesh, or a
          directory (every ``*.obj`` directly inside). Blank lines are
          ignored. EOF shuts the server down.
  stdout  one JSON line per input mesh::

              {"file": ..., "sex": 0|1,
               "reconstruction_error": {"mean": ..., "max": ...},
               "recon": path, "oppo": path}     # paths with save_meshes

          then one ``{"done": N, "sec": T}`` line per request line.
          Malformed requests answer ``{"error": ...}`` and keep serving.

Requests pad to the static batch size (the last mesh repeats) and larger
requests chunk. x travels to the device as float16 by default and is
upcast there; the per-mesh scalars come back as one packed [3, B] array
(pred, err_mean, err_max). Multi-chunk requests run a two-lane pipeline:
the main thread preprocesses chunk i+1 (OBJ parse + Procrustes) while a
single device-lane thread runs chunk i.

With ``serving_step`` (a loaded --export-serve artifact, infer/export.py)
the server runs that step on the uploaded chunk and needs no model,
operators or engine; it runs in one process.

In a world (``dist``, a parallel.World; meshvae_tpu/infer/serve.py:73,83
takes a mesh): every rank handles every request (the primary reads stdin
and broadcasts each line), preprocesses the whole chunk and runs its dp
rows, under sp its vertex rows of them (the engine's row layout); the
packed results and meshes are all-gathered over dp, the meshes over sp
first, and only the primary writes meshes and JSON lines.

Run: ``python -m meshvae_tpu_torch.infer.serve -c cfg [-p key value]
[--params file.npz] [--norm norm.npz] [--seed N] [--no-meshes]
[--device cuda|cpu] [-o output_dir]``. Without ``--params`` the weights are
drawn from ``--seed``; without ``--norm`` the normalisation is mean 0,
std 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent import futures

import numpy as np
import torch

from ..config import apply_overrides, read_config
from ..device import resolve_device
from ..mesh.io import load_obj, save_obj
from ..mesh.procrustes import apply_inverse_similarity, procrustes_align
from ..models.vae import load_params_npz
from ..parallel.sharding import fetch, is_primary, shard_batch
from ..train.driver import build_model_and_ops
from .driver import InferenceEngine


def list_request_meshes(path: str) -> list[str]:
    """A request line resolves to mesh paths: one .obj, or a directory's
    top-level *.obj files (sorted for deterministic output order)."""
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if f.endswith(".obj"))
    return [path]


def packed_step(step, batch: dict, norm_mean: torch.Tensor,
                norm_std: torch.Tensor, collect_meshes: bool) -> dict:
    """The serving contract around an engine step (``InferenceEngine.step``
    or ``_step_impl``): x arrives in the wire dtype and is upcast; the
    ground truth is recomputed on the device from x (aligned @ R * s + m
    with aligned = x * std + mean); the per-mesh scalars come back as one
    packed [3, B] (pred, err_mean, err_max), and with collect_meshes the
    original-pose recon_orig / oppo_orig [B, N, 3]."""
    x = batch["x"].to(torch.float32)
    original = apply_inverse_similarity(x * norm_std + norm_mean, batch["r"],
                                        batch["s"], batch["m"])
    out = step(dict(batch, x=x, original=original), norm_mean, norm_std)
    res = {"packed": torch.stack([out["pred"].to(torch.float32),
                                  out["err_mean"], out["err_max"]])}
    if collect_meshes:
        res["recon_orig"] = out["recon_orig"]
        res["oppo_orig"] = out["oppo_orig"]
    return res


class MeshServer:
    """One warm InferenceEngine + preprocessing, shared across requests:
    OBJ ingest -> Procrustes align to the template -> normalize -> pad/chunk
    to the static batch -> one step per chunk -> packed pull -> JSON results
    (+ optional recon/gt/oppo mesh triples under ``sex_change/``).
    Call ``close()`` to stop the device-lane thread."""

    def __init__(self, model, ops, norm_mean, norm_std, template, faces,
                 batch_size: int, output_path: str = ".",
                 save_meshes: bool = False, wire_dtype=np.float16,
                 device="cuda", dist=None, serving_step=None):
        # serving_step: an (x, r, s, m) -> {packed, ...} callable on
        # `device`, typically a loaded --export-serve artifact
        # (export.load_serving_step); model and ops may then be None. One
        # process only: the artifact is one process's step.
        if serving_step is not None and dist is not None:
            raise ValueError("a serving artifact runs in one process, not "
                             "in a world")
        self.device = dist.device if dist is not None else resolve_device(
            device)
        self.dist = dist
        self.primary = is_primary(dist)
        self._artifact_step = serving_step
        self.engine = (InferenceEngine(model, ops, dist=dist)
                       if serving_step is None else None)
        if self.engine is not None:
            self.mean_dev, self.std_dev = self.engine.norm_to_device(
                norm_mean, norm_std, self.device)
        else:
            self.mean_dev, self.std_dev = (
                torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                for a in (norm_mean, norm_std))
        self.vertex_shard = (self.engine.vertex_shard
                             if self.engine is not None else None)
        self.mean = np.asarray(norm_mean, np.float32)
        self.std = np.asarray(norm_std, np.float32)
        self.template = np.asarray(template, np.float32)
        self.faces = faces
        self.batch_size = int(batch_size)
        self.output_path = output_path
        self.save_meshes = save_meshes
        self.mesh_dir = os.path.join(output_path, "sex_change")
        # x is ~the whole chunk upload and is normalized ~N(0,1): f16 halves
        # its bytes at ~5e-4 relative error; r/s/m stay f32 (m is an
        # absolute translation whose f16 rounding would shift the meshes)
        self.wire_dtype = np.dtype(wire_dtype)
        # single-worker device lane: overlaps chunk i's upload/step/pull
        # with the main thread's preprocess of chunk i+1 (see handle())
        self._device_lane = futures.ThreadPoolExecutor(max_workers=1)

    def close(self) -> None:
        self._device_lane.shutdown(wait=True)

    # --- device side ------------------------------------------------------

    def serve_step(self, batch: dict) -> dict:
        """Device tensors x (wire dtype), r, s, m -> packed [3, B]
        (pred, err_mean, err_max) plus, with save_meshes, the original-pose
        recon/oppo meshes (packed_step, or the artifact's step)."""
        if self._artifact_step is not None:
            out = self._artifact_step(batch["x"], batch["r"], batch["s"],
                                      batch["m"])
            if self.save_meshes and "recon_orig" not in out:
                raise RuntimeError(
                    "serving artifact was exported without mesh outputs "
                    "(--no-meshes); re-export with meshes or serve with "
                    "--no-meshes")
            return out
        return packed_step(self.engine.step, batch, self.mean_dev,
                           self.std_dev, self.save_meshes)

    def _device_chunk(self, host: dict) -> dict:
        """Upload one padded chunk (the rank's dp rows of it), run the step,
        pull the results of the whole chunk. Runs on the device-lane
        thread."""
        rows = shard_batch({k: host[k] for k in ("x", "r", "s", "m")},
                           self.dist, self.vertex_shard)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in rows.items()}
        out = self.serve_step(batch)
        pulled = {"packed": fetch(out["packed"], self.dist, dim=1)}
        if self.save_meshes:
            pulled["recon"] = fetch(out["recon_orig"], self.dist,
                                    rows=self.vertex_shard)
            pulled["oppo"] = fetch(out["oppo_orig"], self.dist,
                                   rows=self.vertex_shard)
        return pulled

    # --- host side --------------------------------------------------------

    def preprocess(self, paths: list[str]) -> dict:
        """Host ingest for one chunk: align + normalize each mesh. Vertex
        counts must match the template."""
        xs, rs, ss, ms, orig = [], [], [], [], []
        n = self.template.shape[0]
        for p in paths:
            points = np.asarray(load_obj(p).v)
            if points.shape[0] != n:
                raise ValueError(
                    f"{p}: {points.shape[0]} vertices, template has {n}")
            aligned, (r, s, m), _ = procrustes_align(self.template, points)
            xs.append(((aligned - self.mean) / self.std).astype(
                self.wire_dtype))
            orig.append(points.astype(np.float32))
            rs.append(r.astype(np.float32))
            ss.append(np.float32(s))
            ms.append(m.astype(np.float32))
        return {"x": np.stack(xs), "r": np.stack(rs),
                "s": np.asarray(ss, np.float32), "m": np.stack(ms),
                "original": np.stack(orig)}

    def _emit(self, pulled: dict, chunk: list[str], host: dict) -> list[dict]:
        """Result dicts (+ recon/gt/oppo writes) for one finished chunk;
        padding rows (indices past len(chunk)) never emit."""
        results = []
        packed = pulled["packed"]
        for i, p in enumerate(chunk):
            name = os.path.basename(p)
            res = {
                "file": name,
                "sex": int(packed[0, i]),
                "reconstruction_error": {"mean": float(packed[1, i]),
                                         "max": float(packed[2, i])},
            }
            if self.save_meshes:
                stem = name.rsplit(".", 1)[0]
                rp = os.path.join(self.mesh_dir, stem + "_recon.obj")
                op = os.path.join(self.mesh_dir, stem + ".obj")
                if self.primary:
                    save_obj(rp, pulled["recon"][i], self.faces)
                    save_obj(os.path.join(self.mesh_dir, stem + "_gt.obj"),
                             host["original"][i], self.faces)
                    save_obj(op, pulled["oppo"][i], self.faces)
                res["recon"] = rp
                res["oppo"] = op
            results.append(res)
        return results

    def handle(self, paths: list[str]) -> list[dict]:
        """Run one request (any number of meshes); one result dict per
        input path. The main thread preprocesses chunk i+1 while the device
        lane runs chunk i."""
        results = []
        if self.save_meshes and self.primary:
            os.makedirs(self.mesh_dir, exist_ok=True)
        bs = self.batch_size
        pending = None  # (future, chunk, host) for the in-flight chunk
        for start in range(0, len(paths), bs):
            chunk = paths[start:start + bs]
            host = self.preprocess(chunk)
            pad = bs - len(chunk)
            if pad:  # static batch: repeat the last row, mask via slicing
                host = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                        for k, v in host.items()}
            fut = self._device_lane.submit(self._device_chunk, host)
            if pending is not None:
                results.extend(self._emit(pending[0].result(), *pending[1:]))
            pending = (fut, chunk, host)
        if pending is not None:
            results.extend(self._emit(pending[0].result(), *pending[1:]))
        return results

    def warmup(self) -> float:
        """Run the step once on a dummy chunk (first-use kernel build and
        allocator warm-up); returns seconds spent."""
        t0 = time.perf_counter()
        n = self.template.shape[0]
        bs = self.batch_size
        host = {
            "x": np.zeros((bs, n, 3), self.wire_dtype),
            "r": np.tile(np.eye(3, dtype=np.float32), (bs, 1, 1)),
            "s": np.ones((bs,), np.float32),
            "m": np.zeros((bs, 1, 3), np.float32),
        }
        self._device_lane.submit(self._device_chunk, host).result()
        return time.perf_counter() - t0

    def _requests(self, fin):
        """Request lines: fin's lines, read by the primary and broadcast to
        the other ranks of a world (None ends the stream)."""
        if self.dist is None or self.dist.size == 1:
            yield from fin
            return
        import torch.distributed as dist

        lines = iter(fin) if self.primary else None
        while True:
            box = [next(lines, None) if self.primary else None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                return
            yield box[0]

    def serve_forever(self, fin, fout) -> None:
        """Blocking stdio loop; EOF on fin ends it. In a world only the
        primary reads fin and writes fout."""
        def emit(obj):
            if self.primary:
                fout.write(json.dumps(obj) + "\n")

        for line in self._requests(fin):
            req = line.strip()
            if not req:
                continue
            t0 = time.perf_counter()
            try:
                paths = list_request_meshes(req)
                if not paths:
                    raise FileNotFoundError(f"no .obj meshes at {req}")
                results = self.handle(paths)
            except Exception as exc:  # keep serving across bad requests
                emit({"error": f"{req}: {exc}"})
                if self.primary:
                    fout.flush()
                continue
            for res in results:
                emit(res)
            emit({"done": len(results),
                  "sec": round(time.perf_counter() - t0, 4)})
            if self.primary:
                fout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve mesh reconstructions over stdio (see module doc)")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", "--param", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"), help="config override")
    ap.add_argument("--params", help="weights: .npz name -> array map")
    ap.add_argument("--norm", help="norm.npz with per-vertex mean and std")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed when --params is not given")
    ap.add_argument("--no-meshes", action="store_true",
                    help="answer scalars only; write no mesh triples")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-o", "--output", default=".",
                    help="directory for the sex_change/ mesh triples")
    args = ap.parse_args(argv)

    config = apply_overrides(read_config(args.config),
                             [tuple(p) for p in args.param])
    device = resolve_device(args.device)
    model, ops, hier, template = build_model_and_ops(
        config, device, generator=torch.Generator().manual_seed(args.seed))
    if args.params:
        model.load_state_dict(load_params_npz(args.params))
    n = hier.levels[0]
    if args.norm:
        with np.load(args.norm) as z:
            mean, std = z["mean"], z["std"]
    else:
        mean = np.zeros((n, 3), np.float32)
        std = np.ones((n, 3), np.float32)
    server = MeshServer(
        model, ops, mean, std, template=template.v, faces=template.f,
        batch_size=config["batch_size"], output_path=args.output,
        save_meshes=not args.no_meshes,
        wire_dtype=np.dtype(config.get("serve_wire_dtype", "float16")),
        device=device)
    try:
        sec = server.warmup()
        print(json.dumps({"ready": True, "warmup_sec": round(sec, 2),
                          "batch_size": server.batch_size}), flush=True)
        server.serve_forever(sys.stdin, sys.stdout)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
