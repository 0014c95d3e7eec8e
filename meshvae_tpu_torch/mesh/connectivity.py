"""Vertex-adjacency construction from triangle faces (counterpart of
meshvae_tpu/mesh/connectivity.py)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def vertex_adjacency(num_vertices: int, faces: np.ndarray) -> sp.csr_matrix:
    """Symmetric adjacency [N, N] from faces [F, 3]; entry (i, j) nonzero iff
    vertices i and j share a face edge."""
    faces = np.asarray(faces, dtype=np.int64)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    data = np.ones(rows.shape[0], dtype=np.float64)
    a = sp.csr_matrix((data, (rows, cols)), shape=(num_vertices, num_vertices))
    a = a + a.T
    a.eliminate_zeros()
    return a


def unique_edges(num_vertices: int, faces: np.ndarray) -> np.ndarray:
    """[E, 2] array of undirected edges with row < col, sorted lexicographically."""
    adj = vertex_adjacency(num_vertices, faces).tocoo()
    mask = adj.row < adj.col
    edges = np.stack([adj.row[mask], adj.col[mask]], axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    return edges[order]


def edge_list(adjacency: sp.spmatrix) -> np.ndarray:
    """Directed edge list [2, nnz] (row; col) from a sparse adjacency, with
    self-loops removed, in deterministic (row-major) order."""
    coo = sp.coo_matrix(adjacency)
    mask = coo.row != coo.col
    row, col = coo.row[mask], coo.col[mask]
    order = np.lexsort((col, row))
    return np.stack([row[order], col[order]], axis=0).astype(np.int64)
