"""mix_ms: the model's Chebyshev basis mix and its weight gradient, device
milliseconds per step (train and eval steps of the traced epochs) of the
kernels of ops/csrc/cheb_mix.cu, by kernel name. A program without those
kernels (the bases concatenated and mixed by cuBLAS) reads nothing."""


def read(ctx):
    win = ctx.get("trace")
    if win is None or not ctx.get("sub_steps"):
        return None
    t = win.device_seconds(lambda name: "cheb_mix" in name)
    return 1e3 * t / ctx["sub_steps"] if t > 0 else None
