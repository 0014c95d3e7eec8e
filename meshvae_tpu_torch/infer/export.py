"""Serving export (counterpart of meshvae_tpu/infer/export.py): the whole
serving step as one ``torch.export`` artifact.

The exported program holds the encoder, the classifier, the
predicted-label reconstruction, the label-swapped counterfactual, the
denormalization and the inverse Procrustes back to the original pose, with
the model's parameters, the normalization statistics and the graph
operators (the block-sparse Laplacians included) as its state. A fresh
process loads it with ``load_serving_step`` and serves without building
the hierarchy, the operators or the model, and without a checkpoint.

Two contracts, with the JAX module's names:

  * ``export_serving_step``: (x, r, s, m) -> {pred, recon_orig, oppo_orig},
    x float32 [B, N, 3] normalized aligned vertices plus the per-mesh
    inverse similarity (r [B, 3, 3], s [B], m [B, 1, 3]); no ground truth,
    no errors;
  * ``export_packed_serving_step``: the serving loop's step
    (serve.packed_step, what ``--serve --artifact`` loads): x in the wire
    dtype (float16 by default), the ground truth recomputed on the device
    from x, packed [3, B] (pred, err_mean, err_max) and, with
    collect_meshes, recon_orig and oppo_orig.

Shapes are static: short batches pad to the exported batch size. The file
is one ``torch.export.save`` archive; its extra file ``HEADER`` is a JSON
header (the contract, collect_meshes, batch_size, num_vertices, the wire
dtype, compute_dtype, matmul_precision, the platforms and the device the
program was traced on). The block-sparse kernel is the registered
operator ``meshvae_torch::bsr_grouped_spmm`` (ops/bsr_spmm.py), so the
archive loads only where this package is importable.

Platforms are "cpu" and "cuda". One program serves both: it is traced on
the model's device (a cuda lowering is traced on the card), stored with
its state on the CPU, and moved to the device it is loaded for
(``torch.export.passes.move_to_device_pass``); there the registered
operator runs the twin on the CPU and launches the kernel on the card.
``load_serving_step`` refuses a device the header does not name. The
artifact is one process's step: export from a world is refused.
"""
from __future__ import annotations

import dataclasses
import io
import json

import torch
import torch.export.passes
from torch import nn

from ..device import resolve_device
from ..models.operators import ModelOperators
from ..ops import bsr_spmm  # noqa: F401 (registers the kernel's operator)
from .driver import InferenceEngine
from .serve import packed_step

PLATFORMS = ("cpu", "cuda")
HEADER = "meshvae_serving.json"


def _tensors(obj, prefix: str):
    """(name, tensor) for every tensor reachable through obj's dataclass
    fields and tuples of dataclasses, named by its path."""
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        name = f"{prefix}_{f.name}"
        if isinstance(value, torch.Tensor):
            yield name, value
        elif dataclasses.is_dataclass(value):
            yield from _tensors(value, name)
        elif isinstance(value, tuple):
            for i, item in enumerate(value):
                if dataclasses.is_dataclass(item):
                    yield from _tensors(item, f"{name}_{i}")


def _rebuild(obj, get):
    """obj with every tensor field replaced by get(tensor)."""
    changes = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, torch.Tensor):
            changes[f.name] = get(value)
        elif dataclasses.is_dataclass(value):
            changes[f.name] = _rebuild(value, get)
        elif isinstance(value, tuple) and any(
                dataclasses.is_dataclass(v) for v in value):
            changes[f.name] = tuple(_rebuild(v, get)
                                    if dataclasses.is_dataclass(v) else v
                                    for v in value)
    return dataclasses.replace(obj, **changes)


class ServingModule(nn.Module):
    """The model, its ModelOperators and the normalization as one module:
    the operators' tensors and the statistics are buffers, so that the
    exported program carries them as its state. forward(x, r, s, m) runs
    the plain contract, or the packed one when `packed`."""

    def __init__(self, model: nn.Module, ops: ModelOperators, norm_mean,
                 norm_std, packed: bool = False,
                 collect_meshes: bool = True):
        super().__init__()
        if any(op.bsr_sp is not None for op in ops.lap + (ops.lap_final,)):
            raise ValueError("export is single-process only: the operators "
                             "are a row shard of a seq_parallel world")
        device = next(model.parameters()).device
        self.model = model
        self.packed = packed
        self.collect_meshes = collect_meshes
        self._ops = ops
        self._names = {}  # id(tensor) -> buffer name; shared tensors once
        for name, t in _tensors(ops, "ops"):
            if id(t) not in self._names:
                self._names[id(t)] = name
                self.register_buffer(name, t)
        for name, value in (("norm_mean", norm_mean), ("norm_std", norm_std)):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=torch.float32).to(device))

    def operators(self) -> ModelOperators:
        """The ModelOperators over this module's buffers (what the trace
        reads)."""
        return _rebuild(self._ops,
                        lambda t: getattr(self, self._names[id(t)]))

    def forward(self, x, r, s, m) -> dict:
        engine = InferenceEngine(self.model, self.operators())
        batch = {"x": x, "r": r, "s": s, "m": m}
        if self.packed:
            return packed_step(engine._step_impl, batch, self.norm_mean,
                               self.norm_std, self.collect_meshes)
        return engine._step_impl(batch, self.norm_mean, self.norm_std)


def make_serving_step(model, ops, norm_mean, norm_std) -> ServingModule:
    """The plain serving step (x, r, s, m) -> {pred, recon_orig,
    oppo_orig} as a module, with the parameters, the statistics and the
    operators as its state."""
    return ServingModule(model, ops, norm_mean, norm_std)


def make_packed_serving_step(model, ops, norm_mean, norm_std,
                             collect_meshes: bool) -> ServingModule:
    """The serving loop's step (x, r, s, m) -> {packed [3, B] and, with
    collect_meshes, recon_orig and oppo_orig}; the ground truth is
    recomputed on the device from x, so the artifact answers with
    reconstruction errors."""
    return ServingModule(model, ops, norm_mean, norm_std, packed=True,
                         collect_meshes=collect_meshes)


def check_platforms(platforms) -> tuple[str, ...]:
    """The platform names, each "cpu" or "cuda"; raises ValueError naming
    the accepted ones otherwise, RuntimeError for "cuda" without a card."""
    names = tuple(dict.fromkeys(platforms))
    bad = [p for p in names if p not in PLATFORMS]
    if bad or not names:
        raise ValueError(f"export platforms {list(bad or names)} are not "
                         f"supported; expected names among {list(PLATFORMS)}")
    if "cuda" in names and not torch.cuda.is_available():
        raise RuntimeError("export platform 'cuda' asked for, but "
                           "torch.cuda.is_available() is False: a cuda "
                           "lowering is exported on the card")
    return names


def _export(module: ServingModule, batch_size: int, num_vertices: int,
            wire_dtype: torch.dtype, platforms, contract: str) -> bytes:
    device = next(module.model.parameters()).device
    platforms = check_platforms(platforms or (device.type,))
    if "cuda" in platforms and device.type != "cuda":
        raise ValueError("a cuda lowering is exported on the card: build "
                         "the model on a CUDA device")
    f32 = torch.float32
    args = (torch.zeros((batch_size, num_vertices, 3), dtype=wire_dtype,
                        device=device),
            torch.eye(3, device=device).expand(batch_size, 3, 3)
            .contiguous(),
            torch.ones((batch_size,), dtype=f32, device=device),
            torch.zeros((batch_size, 1, 3), dtype=f32, device=device))
    with torch.no_grad():  # the engine's step runs without dropout
        program = torch.export.export(module, args, strict=False)
    program = torch.export.passes.move_to_device_pass(program, "cpu")
    cfg = module.model.cfg
    header = {"contract": contract,
              "collect_meshes": module.collect_meshes,
              "batch_size": int(batch_size),
              "num_vertices": int(num_vertices),
              "wire_dtype": str(wire_dtype).removeprefix("torch."),
              "compute_dtype": cfg.compute_dtype,
              "matmul_precision": cfg.precision,
              "platforms": list(platforms),
              "traced_on": device.type}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={HEADER: json.dumps(header)})
    return buf.getvalue()


def export_serving_step(model, ops, norm_mean, norm_std, batch_size: int,
                        num_vertices: int, platforms=None) -> bytes:
    """Serialize the plain serving step for `batch_size` x `num_vertices`
    meshes (x float32). `platforms`: names among PLATFORMS (default: the
    model's device)."""
    return _export(make_serving_step(model, ops, norm_mean, norm_std),
                   batch_size, num_vertices, torch.float32, platforms,
                   "plain")


def export_packed_serving_step(model, ops, norm_mean, norm_std,
                               batch_size: int, num_vertices: int,
                               collect_meshes: bool = True,
                               wire_dtype=torch.float16,
                               platforms=None) -> bytes:
    """Serialize the serving loop's step for ``--serve --artifact``;
    `wire_dtype` must match the server's upload dtype (serve_wire_dtype,
    float16 by default)."""
    module = make_packed_serving_step(model, ops, norm_mean, norm_std,
                                      collect_meshes)
    return _export(module, batch_size, num_vertices, wire_dtype, platforms,
                   "packed")


def save_serving_artifact(path: str, data: bytes) -> None:
    with open(path, "wb") as fp:
        fp.write(data)


@dataclasses.dataclass
class ServingStep:
    """A loaded artifact: call it as step(x, r, s, m) with tensors on the
    device it was loaded for; `header` is the artifact's JSON header,
    `program` the exported program on that device."""

    program: torch.export.ExportedProgram
    header: dict

    def __post_init__(self):
        self._call = self.program.module()

    @torch.inference_mode()
    def __call__(self, x, r, s, m) -> dict:
        return self._call(x, r, s, m)


def load_serving_step(path_or_bytes, device="cuda") -> ServingStep:
    """Load an artifact (a path or its bytes) for `device` ("cuda" unless
    the caller asks for the CPU). Raises ValueError when the artifact has
    no lowering for that device."""
    src = path_or_bytes
    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    extra = {HEADER: ""}
    program = torch.export.load(src, extra_files=extra)
    header = json.loads(extra[HEADER])
    dev = torch.device(device)
    if dev.type not in header["platforms"]:
        raise ValueError(f"the serving artifact has no lowering for device "
                         f"{str(dev)!r}: it was exported for "
                         f"{header['platforms']}")
    dev = resolve_device(dev)
    if dev.type != "cpu":
        program = torch.export.passes.move_to_device_pass(program, str(dev))
    return ServingStep(program, header)
