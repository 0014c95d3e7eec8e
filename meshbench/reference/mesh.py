"""The reference's own mesh arithmetic: the template, its hierarchy, the
scaled Laplacians and the pool matrices, worked out from the raw template
file and never taken from the program.

It is a frozen copy of the port's host preprocessing as of the
benchmark's first version (meshvae_tpu_torch/mesh/: the OBJ reading,
midpoint subdivision with the reverse Cuthill-McKee relabeling, the
template written as ``v %f`` and read back, QSlim decimation by a factor,
the barycentric up-sampling transfer, the face adjacency, and
ops/graph.py's L_hat = -D^-1/2 A D^-1/2). The decimation and the transfer
run in the frozen C++ copy (native.py). A later change to the program's
hierarchy therefore shows as a difference from the reference rather than
moving it.

Templates and hierarchies are cached under ``meshbench/_cache/reference``
(fixed paths in the checkout, keyed by a hash of their inputs).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os

import numpy as np
import scipy.sparse as sp

from . import native

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_cache", "reference")


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [N, 3] float64, faces [F, 3] int64, 0-based) of an OBJ's
    ``v`` and triangle ``f`` lines."""
    verts, faces = [], []
    with open(path) as fp:
        for line in fp:
            if line.startswith("v "):
                verts.append(line.split()[1:4])
            elif line.startswith("f "):
                faces.append([tok.split("/")[0] for tok in line.split()[1:4]])
    v = np.array(verts, dtype=np.float64).reshape(-1, 3)
    f = np.array(faces, dtype=np.int64).reshape(-1, 3) - 1
    return v, f


def vertex_adjacency(n: int, faces: np.ndarray) -> sp.csr_matrix:
    faces = np.asarray(faces, dtype=np.int64)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    a = sp.csr_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(n, n))
    a = a + a.T
    a.eliminate_zeros()
    return a


def scaled_laplacian(adjacency: sp.spmatrix) -> sp.csr_matrix:
    """L_hat = -D^-1/2 A D^-1/2 with unit edge weights, no self-loops (the
    Chebyshev operator of a normalized Laplacian with lambda_max = 2)."""
    coo = sp.coo_matrix(adjacency)
    keep = coo.row != coo.col
    row, col = coo.row[keep], coo.col[keep]
    n = adjacency.shape[0]
    deg = np.zeros(n)
    np.add.at(deg, row, 1.0)
    with np.errstate(divide="ignore"):
        dis = deg ** -0.5
    dis[~np.isfinite(dis)] = 0.0
    return sp.csr_matrix((-dis[row] * dis[col], (row, col)), shape=(n, n))


def _subdivide_midpoint(v: np.ndarray, f: np.ndarray):
    edge_mid: dict[tuple[int, int], int] = {}
    new_verts = [v]
    next_id = v.shape[0]

    def midpoint(a: int, b: int) -> int:
        nonlocal next_id
        key = (a, b) if a < b else (b, a)
        if key not in edge_mid:
            edge_mid[key] = next_id
            new_verts.append(0.5 * (v[a] + v[b])[None, :])
            next_id += 1
        return edge_mid[key]

    new_faces = []
    for a, b, c in f:
        ab = midpoint(int(a), int(b))
        bc = midpoint(int(b), int(c))
        ca = midpoint(int(c), int(a))
        new_faces.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c),
                          (ab, bc, ca)])
    return (np.concatenate(new_verts, axis=0),
            np.asarray(new_faces, dtype=np.int64))


def _reorder_rcm(v: np.ndarray, f: np.ndarray):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    adj = sp.csr_matrix(vertex_adjacency(v.shape[0], f))
    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return v[perm], inv[f]


def _as_written(v: np.ndarray) -> np.ndarray:
    """The vertices as an OBJ of ``v %f %f %f`` lines reads back."""
    text = "\n".join("%f %f %f" % tuple(row) for row in v)
    return np.loadtxt(io.StringIO(text), dtype=np.float64).reshape(-1, 3)


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else json.dumps(p).encode())
    return h.hexdigest()[:16]


def template(path: str, subdivisions: int = 0):
    """(vertices, faces) of the template a config runs: the raw file, or
    after `subdivisions` midpoint subdivisions relabeled by reverse
    Cuthill-McKee and rounded as a written OBJ (the scaled templates)."""
    v, f = load_obj(path)
    if not subdivisions:
        return v, f
    with open(path, "rb") as fp:
        key = _digest(fp.read(), subdivisions, "rcm", "%f")
    cached = os.path.join(CACHE_DIR, f"template_{key}.npz")
    if os.path.exists(cached):
        with np.load(cached) as z:
            return z["v"], z["f"]
    for _ in range(subdivisions):
        v, f = _subdivide_midpoint(v, f)
    v, f = _reorder_rcm(v, f)
    v = _as_written(v)
    _save(cached, v=v, f=f)
    return v, f


def _save(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


@dataclasses.dataclass
class Hierarchy:
    """vertices / faces per level (finest first), the Laplacian L_hat of
    each level, D_i [n_{i+1}, n_i] (selection) and U_i [n_i, n_{i+1}]
    (barycentric rows), all scipy CSR in float64."""

    vertices: list
    faces: list
    laplacians: list
    down: list
    up: list

    @property
    def levels(self) -> list[int]:
        return [v.shape[0] for v in self.vertices]

    def final_operator(self) -> sp.csr_matrix:
        """The last decoder conv's operator under final_conv_adjacency =
        reference_quirk: the coarsest level's L_hat in the top-left
        corner of an [n_0, n_0] operator, zero elsewhere."""
        coarse = sp.coo_matrix(self.laplacians[-1])
        n = self.levels[0]
        return sp.csr_matrix((coarse.data, (coarse.row, coarse.col)),
                             shape=(n, n))


def _transfer(src_v, src_f, tgt_v) -> sp.csr_matrix:
    cols, weights = native.transfer(src_v, src_f, tgt_v)
    t = tgt_v.shape[0]
    rows = np.repeat(np.arange(t), 3)
    mask = cols.ravel() >= 0
    u = sp.csr_matrix((weights.ravel()[mask], (rows[mask], cols.ravel()[mask])),
                      shape=(t, src_v.shape[0]))
    u.sum_duplicates()
    return u


def _build(v, f, factors) -> Hierarchy:
    vertices, faces = [v], [f]
    down, up = [], []
    for factor in factors:
        target = math.ceil(vertices[-1].shape[0] / float(factor))
        # faces come back indexed into the kept vertices
        new_f, kept = native.qslim(vertices[-1], faces[-1], target)
        d = sp.csr_matrix((np.ones(kept.shape[0]),
                           (np.arange(kept.shape[0]), kept)),
                          shape=(kept.shape[0], vertices[-1].shape[0]))
        new_v = d @ vertices[-1]
        down.append(d)
        vertices.append(new_v)
        faces.append(new_f)
        up.append(_transfer(new_v, new_f, vertices[-2]))
    laps = [scaled_laplacian(vertex_adjacency(vv.shape[0], ff))
            for vv, ff in zip(vertices, faces)]
    return Hierarchy(vertices, faces, laps, down, up)


def hierarchy(v: np.ndarray, f: np.ndarray, factors) -> Hierarchy:
    """The template's hierarchy, cached by a hash of the mesh, the factors
    and the native source."""
    with open(native.SOURCE, "rb") as fp:
        src = fp.read()
    key = _digest(np.ascontiguousarray(v).tobytes(),
                  np.ascontiguousarray(f).tobytes(),
                  [float(x) for x in factors], src)
    path = os.path.join(CACHE_DIR, f"hierarchy_{key}.npz")
    if os.path.exists(path):
        return _load(path)
    hier = _build(np.asarray(v, np.float64), np.asarray(f, np.int64),
                  factors)
    payload = {"n": np.array(len(hier.vertices))}
    for i, (vv, ff) in enumerate(zip(hier.vertices, hier.faces)):
        payload[f"v{i}"], payload[f"f{i}"] = vv, ff
    for i, (d, u) in enumerate(zip(hier.down, hier.up)):
        for name, m in (("d", d), ("u", u)):
            c = m.tocoo()
            payload[f"{name}{i}"] = np.stack([c.row, c.col])
            payload[f"{name}{i}_v"] = c.data
            payload[f"{name}{i}_s"] = np.array(m.shape)
    _save(path, **payload)
    return hier


def _load(path: str) -> Hierarchy:
    with np.load(path) as z:
        n = int(z["n"])
        vertices = [z[f"v{i}"] for i in range(n)]
        faces = [z[f"f{i}"] for i in range(n)]

        def mat(name):
            rc = z[name]
            return sp.csr_matrix((z[f"{name}_v"], (rc[0], rc[1])),
                                 shape=tuple(z[f"{name}_s"]))

        down = [mat(f"d{i}") for i in range(n - 1)]
        up = [mat(f"u{i}") for i in range(n - 1)]
    laps = [scaled_laplacian(vertex_adjacency(vv.shape[0], ff))
            for vv, ff in zip(vertices, faces)]
    return Hierarchy(vertices, faces, laps, down, up)
