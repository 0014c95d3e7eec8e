"""PyTorch / CUDA (Hopper) port of meshvae_tpu.

The module layout mirrors ``meshvae_tpu/``: ``mesh/`` (host-side template
hierarchy), ``ops/`` (graph operators, Chebyshev convolution, pooling and the
hand-written block-sparse CUDA kernel), ``models/`` (the VAE) and ``infer/``
(the warm serving engine). The package imports torch, numpy and scipy only:
no JAX, and no module of ``meshvae_tpu``.
"""
