"""Loop-style 1-to-4 triangle subdivision (midpoint split), counterpart of
meshvae_tpu/mesh/subdivide.py.

Synthesizes the scaled templates (files/scaled20k.cfg, files/scaled80k.cfg)
from the 4,998-vertex template: each subdivision adds one vertex per edge
midpoint (~4x vertices). Geometry-preserving midpoint split (no smoothing)
so the shape stays the template's.
"""
from __future__ import annotations

import numpy as np

from .io import TriMesh


def subdivide_midpoint(mesh: TriMesh) -> TriMesh:
    v = np.asarray(mesh.v, dtype=np.float64)
    f = np.asarray(mesh.f, dtype=np.int64)

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
        new_faces.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)])

    return TriMesh(np.concatenate(new_verts, axis=0),
                   np.asarray(new_faces, dtype=np.int64))


def reorder_vertices_rcm(mesh: TriMesh) -> TriMesh:
    """Relabel vertices by reverse Cuthill-McKee over the edge graph.

    Midpoint subdivision appends all edge midpoints after the original
    vertices, destroying the locality the block-sparse kernels feed on:
    the subdivided 20k template's level-0 Laplacian occupies 5,226
    128x128 blocks (33 per block-row) where the RCM relabeling packs the
    same graph into 633 blocks (max 5 per row) — 8x less operator
    streaming per SpMM, and narrow rows for the row-grouped kernel. Pure
    relabeling: the surface, topology, and per-vertex semantics are
    unchanged (vertex order is an internal detail of the
    GENERATED scaled templates; the vendored template5k is never
    touched — its ordering is part of the reference parity surface)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from .connectivity import vertex_adjacency

    adj = sp.csr_matrix(vertex_adjacency(mesh.num_vertices, mesh.f))
    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return TriMesh(np.asarray(mesh.v)[perm], inv[np.asarray(mesh.f)])


def subdivide_to_target(mesh: TriMesh, target_k: int,
                        base_k: int = 5) -> TriMesh:
    """Midpoint-subdivide a ~`base_k`-thousand-vertex mesh until
    ~`target_k` thousand (4x vertices per round), then RCM-relabel for
    block locality: the scaling rule of the scaled-template generator
    (tools/make_scaled_template.ensure_template)."""
    k = base_k
    while k < target_k:
        mesh = subdivide_midpoint(mesh)
        k *= 4
    return reorder_vertices_rcm(mesh)
