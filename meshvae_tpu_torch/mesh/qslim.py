"""Quadric-error-metric (QSlim) mesh decimation — host-side preprocessing
(counterpart of meshvae_tpu/mesh/qslim.py, "fast" mode; the native library
runs the same algorithm when it can be built).

Collapse edges onto an existing endpoint (no new vertex positions),
minimizing summed quadric error, until the number of vertices referenced by
the remaining faces reaches the target; emit the simplified faces plus a
binary selection matrix D mapping parent vertices to kept vertices. Face
planes come from cross products, the priority queue uses lazy invalidation
with per-vertex version stamps, and a union-find tracks collapsed-vertex
representatives. Deterministic: ties broken on (cost, min_vertex,
max_vertex).
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import scipy.sparse as sp

from .connectivity import unique_edges


def face_quadrics(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex 4x4 error quadrics: sum over incident faces of outer(p, p)
    with p = (n, d)/|n_xyz| the unit-normal plane equation of the face."""
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    # Degenerate faces contribute a zero quadric.
    safe = np.where(norm > 0, norm, 1.0)
    n_unit = n / safe
    d = -np.einsum("fi,fi->f", n_unit, p0)[:, None]
    plane = np.concatenate([n_unit, d], axis=1)  # [F, 4]
    plane[norm[:, 0] == 0] = 0.0
    q_face = np.einsum("fi,fj->fij", plane, plane)  # [F, 4, 4]

    quadrics = np.zeros((v.shape[0], 4, 4), dtype=np.float64)
    for k in range(3):
        np.add.at(quadrics, f[:, k], q_face)
    return quadrics


def _vertex_cost(q_sum: np.ndarray, p: np.ndarray) -> float:
    ph = np.array([p[0], p[1], p[2], 1.0])
    return float(ph @ q_sum @ ph)


def qslim_decimate(vertices: np.ndarray, faces: np.ndarray,
                   target_vertices: int):
    """Decimate to <= target_vertices (counted as vertices referenced by the
    remaining faces). The C++ copy of the same algorithm
    (meshvae_tpu_torch/native) runs when it can be built.

    Returns:
      new_faces: [F', 3] int64 faces re-indexed into the kept-vertex space.
      down_mtx:  scipy CSR [n_kept, n_parent] binary selection matrix with
                 down_mtx @ parent_vertices == kept_vertices.
    """
    from ..native import qslim_decimate_native

    native = qslim_decimate_native(vertices, faces, target_vertices)
    if native is not None:
        new_faces, kept = native
        down = sp.csr_matrix(
            (np.ones(kept.shape[0]), (np.arange(kept.shape[0]), kept)),
            shape=(kept.shape[0], np.asarray(vertices).shape[0]))
        return new_faces, down
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64).copy()
    n = v.shape[0]

    quadrics = face_quadrics(v, f)
    edges = unique_edges(n, f)

    # adjacency sets over current representatives
    neighbors: list[set[int]] = [set() for _ in range(n)]
    for a, b in edges:
        neighbors[a].add(int(b))
        neighbors[b].add(int(a))

    version = np.zeros(n, dtype=np.int64)  # bumped on every collapse touching a vertex
    parent = np.arange(n, dtype=np.int64)  # union-find

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    def edge_cost(a: int, b: int):
        q_sum = quadrics[a] + quadrics[b]
        cost_destroy_b = _vertex_cost(q_sum, v[a])  # keep a
        cost_destroy_a = _vertex_cost(q_sum, v[b])  # keep b
        if cost_destroy_b <= cost_destroy_a:
            return cost_destroy_b, a, b, q_sum
        return cost_destroy_a, b, a, q_sum

    heap: list[tuple[float, int, int, int, int]] = []
    for a, b in edges:
        a, b = int(a), int(b)
        cost, _, _, _ = edge_cost(a, b)
        heapq.heappush(heap, (cost, a, b, 0, 0))  # (cost, u, v, ver_u, ver_v)

    # live-vertex count = vertices referenced by faces; track incident face
    # counts instead of rescanning.
    face_alive = np.ones(f.shape[0], dtype=bool)
    incident: list[set[int]] = [set() for _ in range(n)]
    for fi in range(f.shape[0]):
        for k in range(3):
            incident[f[fi, k]].add(fi)
    n_live = int(np.unique(f).shape[0])

    while n_live > target_vertices and heap:
        cost, a, b, va, vb = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if version[ra] != va or version[rb] != vb or a != ra or b != rb:
            # stale entry: re-push with fresh cost/versions if still an edge
            if rb in neighbors[ra]:
                c2, keep, destroy, _ = edge_cost(ra, rb)
                u, w = (ra, rb) if ra < rb else (rb, ra)
                heapq.heappush(heap, (c2, u, w, int(version[u]), int(version[w])))
            continue

        c_now, keep, destroy, q_sum = edge_cost(ra, rb)
        if c_now > cost:
            heapq.heappush(heap, (c_now, a, b, va, vb))
            continue

        # collapse: destroy -> keep
        parent[destroy] = keep
        quadrics[keep] = q_sum
        version[keep] += 1
        version[destroy] += 1

        # merge adjacency
        neighbors[destroy].discard(keep)
        neighbors[keep].discard(destroy)
        for nb in neighbors[destroy]:
            neighbors[nb].discard(destroy)
            if nb != keep:
                neighbors[nb].add(keep)
                neighbors[keep].add(nb)
        neighbors[destroy] = set()

        # update faces incident to the destroyed vertex; drop degenerates
        touched = incident[destroy]
        for fi in list(touched):
            if not face_alive[fi]:
                continue
            tri = f[fi]
            tri[tri == destroy] = keep
            if tri[0] == tri[1] or tri[1] == tri[2] or tri[2] == tri[0]:
                face_alive[fi] = False
                for vv in set(int(x) for x in tri):
                    incident[vv].discard(fi)
            else:
                incident[keep].add(fi)
        incident[destroy] = set()

        # re-queue edges around the kept vertex with fresh costs
        for nb in neighbors[keep]:
            c2, _, _, _ = edge_cost(keep, nb)
            u, w = (keep, nb) if keep < nb else (nb, keep)
            heapq.heappush(heap, (c2, u, w, int(version[u]), int(version[w])))

        live_faces = f[face_alive]
        n_live = int(np.unique(live_faces).shape[0]) if live_faces.size else 0

    live_faces = f[face_alive]
    return reindex_faces(live_faces, n)


def reindex_faces(faces: np.ndarray, num_parent_vertices: int):
    """Compact faces onto the vertices they reference; return (new_faces, D)
    with D [n_kept, n_parent] the binary selection matrix."""
    kept = np.unique(faces)
    remap = np.full(num_parent_vertices, -1, dtype=np.int64)
    remap[kept] = np.arange(kept.shape[0])
    new_faces = remap[faces]
    down = sp.csr_matrix(
        (np.ones(kept.shape[0]), (np.arange(kept.shape[0]), kept)),
        shape=(kept.shape[0], num_parent_vertices),
    )
    return new_faces, down


def decimate_by_factor(vertices: np.ndarray, faces: np.ndarray,
                       factor: float):
    """Keep ceil(N / factor) vertices (factor=4 keeps a quarter)."""
    target = math.ceil(vertices.shape[0] / factor)
    return qslim_decimate(vertices, faces, target)
