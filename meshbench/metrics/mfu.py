"""mfu: the model's operations in the window (meshbench/workcount.py, from
shapes and nonzeros) over the window's seconds and the configuration's
peak, in percent."""


def read(ctx):
    if not ctx.get("flops_window"):
        return None
    return 100.0 * ctx["flops_window"] / (ctx["window_s"] * ctx["peak"])
