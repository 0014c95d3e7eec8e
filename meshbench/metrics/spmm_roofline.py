"""spmm_roofline: the Laplacian kernel, the least time of the traced calls
of bsr_grouped_spmm (CSR bytes at the card's bandwidth or operations at
the mode's peak, meshbench/workcount.py) over the profiler's device time
of those calls, in percent."""
from meshbench.workcount import spmm_least_seconds


def read(ctx):
    win, calls = ctx.get("trace"), ctx.get("sub_launches")
    if win is None or not calls:
        return None
    t = win.device_seconds(lambda name: "bsr_grouped_spmm" in name)
    if t <= 0:
        return None
    return 100.0 * spmm_least_seconds(calls, ctx["shape"],
                                      ctx["batches"]) / t
