"""Barycentric upsampling-matrix construction, coarse -> fine (counterpart
of meshvae_tpu/mesh/transfer.py, both modes; in "barycentric" mode the
native library runs the same projection when it can be built).

Candidate triangles come from a cKDTree over face centroids plus every face
incident to the nearest source vertex; the exact closest point on each
candidate triangle is found by region-based point-triangle projection,
which yields barycentric coordinates directly. "reference" mode keeps the
reference implementation's per-branch coefficients (``_reference_transfer``,
numpy only), whose edge rows do not sum to 1.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree


def closest_point_triangle(p: np.ndarray, a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Exact closest point on triangle (a, b, c) to point p.

    Returns (point, (w_a, w_b, w_c)) barycentric weights of the closest point.
    Ericson, "Real-Time Collision Detection", ch. 5.1.5.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = ab @ ap
    d2 = ac @ ap
    if d1 <= 0.0 and d2 <= 0.0:
        return a, (1.0, 0.0, 0.0)

    bp = p - b
    d3 = ab @ bp
    d4 = ac @ bp
    if d3 >= 0.0 and d4 <= d3:
        return b, (0.0, 1.0, 0.0)

    vc = d1 * d4 - d3 * d2
    if vc <= 0.0 and d1 >= 0.0 and d3 <= 0.0:
        t = d1 / (d1 - d3)
        return a + t * ab, (1.0 - t, t, 0.0)

    cp = p - c
    d5 = ab @ cp
    d6 = ac @ cp
    if d6 >= 0.0 and d5 <= d6:
        return c, (0.0, 0.0, 1.0)

    vb = d5 * d2 - d1 * d6
    if vb <= 0.0 and d2 >= 0.0 and d6 <= 0.0:
        t = d2 / (d2 - d6)
        return a + t * ac, (1.0 - t, 0.0, t)

    va = d3 * d6 - d5 * d4
    if va <= 0.0 and (d4 - d3) >= 0.0 and (d5 - d6) >= 0.0:
        t = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        return b + t * (c - b), (0.0, 1.0 - t, t)

    denom = 1.0 / (va + vb + vc)
    v = vb * denom
    w = vc * denom
    return a + ab * v + ac * w, (1.0 - v - w, v, w)


def barycentric_transfer(source_v: np.ndarray, source_f: np.ndarray,
                         target_v: np.ndarray, n_candidates: int = 16,
                         mode: str = "barycentric") -> sp.csr_matrix:
    """Build U [n_target, n_source] with U @ source_vertices approximating
    target_vertices via the nearest surface point.

    mode "barycentric" (default) emits the barycentric weights of the
    nearest point, affine rows that sum to 1; the C++ uniform-grid
    implementation (meshvae_tpu_torch/native) runs when it can be built.
    mode "reference" reproduces the reference's per-branch coefficients
    (``_reference_transfer``, never native): face-interior points solve the
    3x3 system at the nearest point (= barycentric), but edge-classified
    points least-squares the ORIGINAL target point onto the linear span of
    the edge's two vertices, rows that do NOT sum to 1. Weights trained on
    the reference's hierarchy bake in those rows."""
    if mode == "reference":
        return _reference_transfer(source_v, source_f, target_v, n_candidates)
    if mode != "barycentric":
        raise ValueError(f"unknown transfer mode: {mode!r}")
    from ..native import barycentric_transfer_native

    native = barycentric_transfer_native(source_v, source_f, target_v)
    if native is not None:
        cols, weights = native
        t = np.asarray(target_v).shape[0]
        rows = np.repeat(np.arange(t), 3)
        mask = cols.ravel() >= 0
        u = sp.csr_matrix(
            (weights.ravel()[mask], (rows[mask], cols.ravel()[mask])),
            shape=(t, np.asarray(source_v).shape[0]))
        u.sum_duplicates()
        return u
    source_v = np.asarray(source_v, dtype=np.float64)
    source_f = np.asarray(source_f, dtype=np.int64)
    target_v = np.asarray(target_v, dtype=np.float64)

    rows, cols, vals = [], [], []
    for i, best_face, _, best_w in _nearest_on_surface(source_v, source_f,
                                                       target_v, n_candidates):
        tri = source_f[best_face]
        for k in range(3):
            if best_w[k] != 0.0:
                rows.append(i)
                cols.append(int(tri[k]))
                vals.append(best_w[k])

    u = sp.csr_matrix(
        (np.array(vals), (np.array(rows), np.array(cols))),
        shape=(target_v.shape[0], source_v.shape[0]),
    )
    u.sum_duplicates()
    return u


def _nearest_on_surface(source_v, source_f, target_v, n_candidates: int = 16):
    """Yield (i, face_idx, nearest_point, (w_a, w_b, w_c)) for each target
    vertex: exact closest point over candidate triangles from a centroid
    KD-tree plus every face incident to the nearest source vertex."""
    centroids = source_v[source_f].mean(axis=1)
    cent_tree = cKDTree(centroids)
    vert_tree = cKDTree(source_v)

    # faces incident to each source vertex, so vertex-nearest candidates are
    # guaranteed to include every face touching the nearest vertex
    incident: list[list[int]] = [[] for _ in range(source_v.shape[0])]
    for fi, tri in enumerate(source_f):
        for k in range(3):
            incident[tri[k]].append(fi)

    k_cent = min(n_candidates, source_f.shape[0])
    _, cand_faces = cent_tree.query(target_v, k=k_cent)
    cand_faces = np.atleast_2d(cand_faces)
    _, nearest_verts = vert_tree.query(target_v, k=1)

    for i in range(target_v.shape[0]):
        p = target_v[i]
        candidates = set(int(x) for x in cand_faces[i])
        candidates.update(incident[int(nearest_verts[i])])

        best_d2 = np.inf
        best_face = -1
        best_q = p
        best_w = (1.0, 0.0, 0.0)
        for fi in sorted(candidates):
            tri = source_f[fi]
            q, w = closest_point_triangle(p, source_v[tri[0]],
                                          source_v[tri[1]], source_v[tri[2]])
            d2 = float(np.sum((p - q) ** 2))
            if d2 < best_d2 - 1e-18:
                best_d2, best_face, best_q, best_w = d2, fi, q, w
        yield i, best_face, best_q, best_w


# psbody AABB "part" ids (mesh_operations.py:227-240): 0 = face interior,
# 1..3 = edge (f[part-1], f[part % 3]), 4..6 = vertex f[part-4].
_EDGE_PART = {(0, 1): 1, (1, 2): 2, (0, 2): 3}


def classify_part(w, eps: float = 0.0):
    """Map barycentric weights of a closest point to the psbody part id."""
    zero = [k for k in range(3) if abs(w[k]) <= eps]
    if len(zero) == 2:
        (nz,) = [k for k in range(3) if k not in zero]
        return 4 + nz
    if len(zero) == 1:
        nz = tuple(k for k in range(3) if k not in zero)
        return _EDGE_PART[nz]
    return 0


def _reference_transfer(source_v, source_f, target_v,
                        n_candidates: int = 16) -> sp.csr_matrix:
    """U with the reference's exact per-branch coefficients
    (mesh_operations.py:213-240), driven by our exact nearest-point query in
    place of the psbody AABB tree. lstsq with rcond=-1 matches the legacy
    default the reference runs under."""
    source_v = np.asarray(source_v, dtype=np.float64)
    source_f = np.asarray(source_f, dtype=np.int64)
    target_v = np.asarray(target_v, dtype=np.float64)

    rows, cols, vals = [], [], []

    def emit(i, col, val):
        rows.append(i)
        cols.append(int(col))
        vals.append(float(val))

    for i, fi, q, w in _nearest_on_surface(source_v, source_f, target_v,
                                           n_candidates):
        tri = source_f[fi]
        part = classify_part(w)
        if part == 0:
            # interior: 3x3 solve at the nearest point (= barycentric)
            a = np.vstack((source_v[tri])).T
            coeffs = np.linalg.lstsq(a, q, rcond=-1)[0]
            for k in range(3):
                emit(i, tri[k], coeffs[k])
        elif part <= 3:
            # edge: least-squares the ORIGINAL point onto the linear span of
            # the edge vertices (not affine -> rows need not sum to 1)
            e0, e1 = tri[part - 1], tri[part % 3]
            a = np.vstack((source_v[e0], source_v[e1])).T
            coeffs = np.linalg.lstsq(a, target_v[i], rcond=-1)[0]
            emit(i, e0, coeffs[0])
            emit(i, e1, coeffs[1])
        else:
            emit(i, tri[part - 4], 1.0)

    u = sp.csr_matrix(
        (np.array(vals), (np.array(rows), np.array(cols))),
        shape=(target_v.shape[0], source_v.shape[0]),
    )
    u.sum_duplicates()
    return u
