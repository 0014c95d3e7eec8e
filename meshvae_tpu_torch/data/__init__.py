from .dataset import BatchIterator, MeshDataset, list_meshes
from .synthetic import generate_synthetic_dataset

__all__ = ["BatchIterator", "MeshDataset", "list_meshes",
           "generate_synthetic_dataset"]
