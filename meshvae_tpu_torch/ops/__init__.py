from .bsr_spmm import bsr_grouped_spmm, bsr_grouped_spmm_reference
from .cheb import cheb_conv
from .pool import pool_apply

__all__ = ["bsr_grouped_spmm", "bsr_grouped_spmm_reference", "cheb_conv",
           "pool_apply"]
