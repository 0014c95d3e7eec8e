from .synthetic import generate_synthetic_dataset

__all__ = ["generate_synthetic_dataset"]
