"""Mesh hierarchy construction: the COMA-style multiresolution pyramid
(counterpart of meshvae_tpu/mesh/hierarchy.py).

Per level, QSlim-decimate the previous mesh by 1/factor, record the binary
downsampling matrix D, the new adjacency A, and the upsampling matrix U
back to the previous level. Two modes: "fast" (the default; the native
library when it builds) and "reference", the reference implementation's
bit-exact collapse order and transfer coefficients, which weights trained
on its hierarchy need (train/torch_import.py). Results are cached to disk
in the same npz format, under the same keys, as the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile

import numpy as np
import scipy.sparse as sp

from .connectivity import vertex_adjacency
from .io import TriMesh
from .qslim import decimate_by_factor
from .transfer import barycentric_transfer


@dataclasses.dataclass
class MeshHierarchy:
    """Static multiresolution pyramid over a fixed-topology template.

    vertices:    per-level vertex arrays [N_i, 3] (finest first).
    faces:       per-level face arrays [F_i, 3].
    adjacency:   per-level CSR adjacency [N_i, N_i] (L+1 entries).
    downsample:  L CSR matrices D_i: [N_{i+1}, N_i], binary selection.
    upsample:    L CSR matrices U_i: [N_i, N_{i+1}], barycentric rows.
    """

    vertices: list[np.ndarray]
    faces: list[np.ndarray]
    adjacency: list[sp.csr_matrix]
    downsample: list[sp.csr_matrix]
    upsample: list[sp.csr_matrix]

    @property
    def levels(self) -> list[int]:
        return [v.shape[0] for v in self.vertices]

    @property
    def num_levels(self) -> int:
        return len(self.vertices)


def build_hierarchy(mesh: TriMesh, factors: list[int],
                    mode: str = "fast") -> MeshHierarchy:
    """mode "fast" or "reference" (qslim.qslim_decimate_exact and the
    reference transfer, numpy only; module docstring)."""
    vertices = [np.asarray(mesh.v, dtype=np.float64)]
    faces = [np.asarray(mesh.f, dtype=np.int64)]
    adjacency = [vertex_adjacency(mesh.num_vertices, mesh.f)]
    downsample: list[sp.csr_matrix] = []
    upsample: list[sp.csr_matrix] = []

    for factor in factors:
        new_f, d = decimate_by_factor(vertices[-1], faces[-1], float(factor),
                                      mode=mode)
        new_v = d @ vertices[-1]
        downsample.append(d.tocsr())
        vertices.append(new_v)
        faces.append(new_f)
        adjacency.append(vertex_adjacency(new_v.shape[0], new_f))
        # U maps the new (coarse) level back up to the previous (fine) level
        upsample.append(barycentric_transfer(
            new_v, new_f, vertices[-2],
            mode="reference" if mode == "reference" else "barycentric"))

    return MeshHierarchy(vertices, faces, adjacency, downsample, upsample)


def _cache_key(mesh: TriMesh, factors: list[int], mode: str = "fast") -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.v).tobytes())
    h.update(np.ascontiguousarray(mesh.f).tobytes())
    h.update(json.dumps([float(f) for f in factors]).encode())
    if mode != "fast":  # fast-mode keys stay those of earlier cache entries
        h.update(mode.encode())
    return h.hexdigest()[:16]


def _save(path: str, hier: MeshHierarchy) -> None:
    payload: dict[str, np.ndarray] = {"num_levels": np.array(hier.num_levels)}
    for i in range(hier.num_levels):
        payload[f"v{i}"] = hier.vertices[i]
        payload[f"f{i}"] = hier.faces[i]
        a = hier.adjacency[i].tocoo()
        payload[f"a{i}_rc"] = np.stack([a.row, a.col])
        payload[f"a{i}_data"] = a.data
        payload[f"a{i}_shape"] = np.array(a.shape)
    for i in range(hier.num_levels - 1):
        for name, mat in (("d", hier.downsample[i]), ("u", hier.upsample[i])):
            m = mat.tocoo()
            payload[f"{name}{i}_rc"] = np.stack([m.row, m.col])
            payload[f"{name}{i}_data"] = m.data
            payload[f"{name}{i}_shape"] = np.array(m.shape)
    np.savez_compressed(path, **payload)


def _load(path: str) -> MeshHierarchy:
    z = np.load(path)
    n = int(z["num_levels"])

    def coo(prefix: str) -> sp.csr_matrix:
        rc = z[f"{prefix}_rc"]
        return sp.csr_matrix(
            (z[f"{prefix}_data"], (rc[0], rc[1])), shape=tuple(z[f"{prefix}_shape"])
        )

    return MeshHierarchy(
        vertices=[z[f"v{i}"] for i in range(n)],
        faces=[z[f"f{i}"] for i in range(n)],
        adjacency=[coo(f"a{i}") for i in range(n)],
        downsample=[coo(f"d{i}") for i in range(n - 1)],
        upsample=[coo(f"u{i}") for i in range(n - 1)],
    )


def load_or_build_hierarchy(mesh: TriMesh, factors: list[int],
                            cache_dir: str | None = None,
                            mode: str = "fast") -> MeshHierarchy:
    """Build the hierarchy, memoized on disk keyed by (template hash,
    factors, mode). The default cache directory is the port's own."""
    if cache_dir is None:
        cache_dir = os.path.join(os.path.expanduser("~"), ".cache",
                                 "meshvae_tpu_torch")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir,
                        f"hierarchy_{_cache_key(mesh, factors, mode)}.npz")
    if os.path.exists(path):
        try:
            return _load(path)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            pass  # corrupt cache entry: rebuild it
    hier = build_hierarchy(mesh, factors, mode=mode)
    _save(path, hier)
    return hier
