from .gcn import ChebGCN, GCNConfig
from .joint import JointMeshVAE, build_joint_model, grad_reverse, joint_loss
from .operators import ModelOperators, build_operators
from .vae import (MeshVAE, VAEConfig, load_params_npz, params_from_flax,
                  save_params_npz)

__all__ = ["ModelOperators", "build_operators", "MeshVAE", "VAEConfig",
           "ChebGCN", "GCNConfig", "JointMeshVAE", "build_joint_model",
           "grad_reverse", "joint_loss", "params_from_flax",
           "save_params_npz", "load_params_npz"]
