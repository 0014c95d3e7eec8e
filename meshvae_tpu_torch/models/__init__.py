from .operators import ModelOperators, build_operators
from .vae import (MeshVAE, VAEConfig, load_params_npz, params_from_flax,
                  save_params_npz)

__all__ = ["ModelOperators", "build_operators", "MeshVAE", "VAEConfig",
           "params_from_flax", "save_params_npz", "load_params_npz"]
