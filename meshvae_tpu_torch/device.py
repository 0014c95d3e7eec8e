"""Device selection for the port's entry points.

Entry points default to ``"cuda"``; the CPU runs only when the caller names
it. A CUDA request without a card raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; raises RuntimeError when a CUDA device
    is asked for and none is present. On CUDA it also pins full-fp32 dense
    products: TF32 (about three decimal digits) would break the 1e-5
    parity bars that ``matmul_precision`` promises; and it keeps cuBLAS's
    split-K partial sums of bf16 products in fp32, as the JAX package
    accumulates bf16 products in fp32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {device!r}")
    return dev
