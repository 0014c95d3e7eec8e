from .io import load_obj, save_obj, TriMesh
from .connectivity import edge_list, vertex_adjacency, unique_edges
from .hierarchy import MeshHierarchy, build_hierarchy, load_or_build_hierarchy
from .procrustes import procrustes_align, apply_inverse_similarity

__all__ = [
    "load_obj", "save_obj", "TriMesh",
    "vertex_adjacency", "unique_edges", "edge_list",
    "MeshHierarchy", "build_hierarchy", "load_or_build_hierarchy",
    "procrustes_align", "apply_inverse_similarity",
]
