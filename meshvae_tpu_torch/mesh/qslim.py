"""Quadric-error-metric (QSlim) mesh decimation — host-side preprocessing
(counterpart of meshvae_tpu/mesh/qslim.py, both modes).

Collapse edges onto an existing endpoint (no new vertex positions),
minimizing summed quadric error, until the number of vertices referenced by
the remaining faces reaches the target; emit the simplified faces plus a
binary selection matrix D mapping parent vertices to kept vertices.

"fast" mode (``qslim_decimate``; the native library runs the same algorithm
when it can be built): face planes come from cross products, the priority
queue uses lazy invalidation with per-vertex version stamps, and a
union-find tracks collapsed-vertex representatives. Deterministic: ties
broken on (cost, min_vertex, max_vertex).

"reference" mode (``qslim_decimate_exact``, pure numpy, never native):
the reference implementation's exact collapse order, for weights trained
on its hierarchy (see the block comment above ``reference_quadrics``).
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
                       factor: float, mode: str = "fast"):
    """Keep ceil(N / factor) vertices (factor=4 keeps a quarter). mode:
    "fast" (the lazy-invalidation queue, default) or "reference" (the
    reference's bit-exact collapse order, for importing weights trained
    on its hierarchy)."""
    target = math.ceil(vertices.shape[0] / factor)
    if mode == "reference":
        return qslim_decimate_exact(vertices, faces, target)
    if mode != "fast":
        raise ValueError(f"unknown hierarchy mode: {mode!r}")
    return qslim_decimate(vertices, faces, target)


# ---------------------------------------------------------------------------
# Reference-exact mode.
#
# The fast path above makes its own (equally valid) collapse choices, so its
# hierarchy differs from the reference's by a couple of vertices per level on
# real meshes (near-tie collapses resolve differently). That is fine for
# training from scratch, but a checkpoint TRAINED on the reference's
# hierarchy only reproduces its outputs on the reference's exact D/U/A — so
# the torch-checkpoint import path needs a decimator that reproduces the
# reference's collapse order bit-for-bit (mesh_operations.py:87-199),
# including its load-bearing quirks:
#
#   * per-face plane equations from an SVD null vector normalized by the
#     normal's length (mesh_operations.py:56-63) — same plane as a cross
#     product but different last-ulp floats, which decide near-tie collapses;
#   * edge cost = min over the two endpoints of the summed quadric evaluated
#     AT THE KEPT endpoint (collapse_cost, :116-127); the collapsed vertex
#     keeps the surviving endpoint's position (D is pure selection);
#   * a lazily-invalidated binary heap where popped entries are re-pushed
#     only when their recomputed cost strictly INCREASED (:153-157), and
#     collapse renames rewrite queue entries IN PLACE without re-heapifying
#     (:175-180) — the heap invariant is intentionally violated, so the pop
#     order depends on CPython heapq's exact sift algorithm;
#   * termination on the number of vertices still referenced by faces
#     (:196), not on collapse count.
#
# The implementation below reproduces those semantics with the queue stored
# as parallel numpy arrays (cost/u/v) managed by the same sift algorithm as
# CPython's heapq, which turns the reference's O(queue)-per-collapse Python
# rename scans into vectorized masks. It is a copy of the JAX package's
# (tests/test_torch_reference_mode.py holds the two bit-equal); the float
# order of every step is part of the result, so it stays as written.
# ---------------------------------------------------------------------------


def reference_quadrics(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex quadrics with the reference's exact float behavior
    (mesh_operations.py:45-70): per-face SVD plane fit, accumulated face-major
    (k inner). The batched-SVD/cross-product variants differ by ~1e-9, enough
    to flip near-tie collapse decisions downstream."""
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    quadrics = np.zeros((v.shape[0], 4, 4))
    ones_col = np.ones((3, 1))
    for i in range(f.shape[0]):
        plane_pts = np.hstack((v[f[i]], ones_col))  # [3, 4] homogeneous
        _, _, vt = np.linalg.svd(plane_pts)
        eq = vt[-1, :].reshape(-1, 1)
        eq = eq / np.linalg.norm(eq[0:3])
        q_face = np.outer(eq, eq)
        for k in range(3):
            quadrics[f[i, k]] += q_face
    return quadrics


class _RenamableHeap:
    """Binary min-heap over (cost, u, v) triples on parallel numpy arrays.

    Implements the exact sift algorithm of CPython's heapq (push: sift toward
    root; pop: move last to root, sift the smaller child up to a leaf, then
    sift toward root) with lexicographic (cost, u, v) ordering — the same
    ordering as heapq on the reference's (cost, (r, c)) tuples. Entries may
    be renamed in place (no re-heapify), replicating the reference's
    invariant-breaking queue rewrite (mesh_operations.py:175-180): after a
    rename, pops still follow exactly what heapq would do on the same list.
    """

    def __init__(self, capacity: int):
        self.cost = np.empty(capacity, dtype=np.float64)
        self.u = np.empty(capacity, dtype=np.int64)
        self.v = np.empty(capacity, dtype=np.int64)
        self.n = 0

    def _grow(self):
        cap = 2 * self.cost.shape[0]
        for name in ("cost", "u", "v"):
            arr = getattr(self, name)
            new = np.empty(cap, dtype=arr.dtype)
            new[: self.n] = arr[: self.n]
            setattr(self, name, new)

    def _less_than_slot(self, c, u, v, j) -> bool:
        cj = self.cost[j]
        if c != cj:
            return c < cj
        uj = self.u[j]
        if u != uj:
            return u < uj
        return v < self.v[j]

    def _slot_less_than_slot(self, i, j) -> bool:
        return self._less_than_slot(self.cost[i], self.u[i], self.v[i], j)

    def _move(self, src, dst):
        self.cost[dst] = self.cost[src]
        self.u[dst] = self.u[src]
        self.v[dst] = self.v[src]

    def _set(self, pos, c, u, v):
        self.cost[pos] = c
        self.u[pos] = u
        self.v[pos] = v

    def _sift_toward_root(self, startpos, pos, c, u, v):
        while pos > startpos:
            parent = (pos - 1) >> 1
            if self._less_than_slot(c, u, v, parent):
                self._move(parent, pos)
                pos = parent
            else:
                break
        self._set(pos, c, u, v)

    def push(self, c: float, u: int, v: int):
        if self.n == self.cost.shape[0]:
            self._grow()
        pos = self.n
        self.n += 1
        self._sift_toward_root(0, pos, c, u, v)

    def pop(self):
        last = self.n - 1
        self.n = last
        lc, lu, lv = self.cost[last], self.u[last], self.v[last]
        if last == 0:
            return float(lc), int(lu), int(lv)
        out = (float(self.cost[0]), int(self.u[0]), int(self.v[0]))
        # heapq._siftup: walk the smaller child up to a leaf...
        pos, end = 0, last
        child = 1
        while child < end:
            right = child + 1
            if right < end and not self._slot_less_than_slot(child, right):
                child = right
            self._move(child, pos)
            pos = child
            child = 2 * pos + 1
        # ...then place the moved item and sift it toward the root
        self._sift_toward_root(0, pos, lc, lu, lv)
        return out

    def rename(self, old: int, new: int):
        """In-place endpoint rewrite with NO re-heapify. Both masks are taken
        on the pre-rename state, as the reference computes which1/which2
        before applying either (mesh_operations.py:175-180)."""
        m1 = self.u[: self.n] == old
        m2 = self.v[: self.n] == old
        self.u[: self.n][m1] = new
        self.v[: self.n][m2] = new


def _reference_edge_pairs(num_vertices: int, faces: np.ndarray):
    """Initial queue (r, c) sequence in the reference's push order: directed
    connectivity summed per face-column as csc (mesh_operations.py:19-28),
    uniqued r<c (:38-41), re-symmetrized, then iterated in csc->coo order
    skipping r>c (:112-137)."""
    n = num_vertices
    conn = sp.csc_matrix((n, n))
    for i in range(3):
        src = faces[:, i]
        dst = faces[:, (i + 1) % 3]
        m = sp.csc_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
        conn = conn + m + m.T
    coo = sp.coo_matrix(conn)
    upper = coo.row < coo.col
    r0, c0 = coo.row[upper], coo.col[upper]
    adj = sp.csc_matrix((np.ones(len(r0)), (r0, c0)), shape=(n, n))
    adj = (adj + adj.T).tocoo()
    keep = adj.row <= adj.col
    return adj.row[keep].astype(np.int64), adj.col[keep].astype(np.int64)


def _endpoint_costs(quadrics, v, r: int, c: int):
    """collapse_cost (mesh_operations.py:116-127) with its exact dot shapes:
    (1,4)@(4,4)@(4,1) on float64. Returns (destroy_c, destroy_r, Qsum):
    destroy_c = error of the merged quadric at r's position (c destroyed)."""
    q_sum = quadrics[r] + quadrics[c]
    p_r = np.concatenate([v[r], [1.0]]).reshape(-1, 1)
    p_c = np.concatenate([v[c], [1.0]]).reshape(-1, 1)
    destroy_c = p_r.T.dot(q_sum).dot(p_r)[0, 0]
    destroy_r = p_c.T.dot(q_sum).dot(p_c)[0, 0]
    return destroy_c, destroy_r, q_sum


def qslim_decimate_exact(vertices: np.ndarray, faces: np.ndarray,
                         target_vertices: int):
    """Decimate with the reference's exact collapse order (see block comment
    above). Returns (new_faces, D) like qslim_decimate."""
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64).copy()
    n = v.shape[0]

    quadrics = reference_quadrics(v, f)
    rows, cols = _reference_edge_pairs(n, f)
    heap = _RenamableHeap(2 * rows.shape[0] + 64)
    for r, c in zip(rows, cols):
        destroy_c, destroy_r, _ = _endpoint_costs(quadrics, v, int(r), int(c))
        heap.push(min(destroy_c, destroy_r), int(r), int(c))

    n_live = n
    while n_live > target_vertices:
        if heap.n == 0:
            raise RuntimeError(
                f"edge queue exhausted at {n_live} > {target_vertices} "
                "vertices (disconnected or degenerate mesh)")
        popped_cost, r, c = heap.pop()
        if r == c:
            continue  # entry fully merged by earlier renames
        destroy_c, destroy_r, q_sum = _endpoint_costs(quadrics, v, r, c)
        fresh_cost = min(destroy_c, destroy_r)
        if fresh_cost > popped_cost:
            # cost went stale-high: re-queue; equal-or-lower proceeds
            # (strict >, mesh_operations.py:154-157)
            heap.push(fresh_cost, r, c)
            continue
        if destroy_c < destroy_r:
            destroy, keep = c, r
        else:
            destroy, keep = r, c

        f[f == destroy] = keep
        heap.rename(destroy, keep)
        # BOTH endpoints get the merged quadric (mesh_operations.py:182-183)
        quadrics[r] = q_sum
        quadrics[c] = q_sum

        degenerate = ((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2])
                      | (f[:, 2] == f[:, 0]))
        f = f[~degenerate].copy()
        n_live = int(np.unique(f).shape[0])

    return reindex_faces(f, n)
