"""cat_ms: the model's concatenation of the Chebyshev bases, device
milliseconds per step (train and eval steps of the traced epochs) of the
concatenation kernels, by kernel name."""


def read(ctx):
    win = ctx.get("trace")
    if win is None or not ctx.get("sub_steps"):
        return None
    t = win.device_seconds(lambda name: "CatArrayBatchedCopy" in name)
    return 1e3 * t / ctx["sub_steps"] if t > 0 else None
