"""host_ms_per_step: the train loop, host milliseconds inside the window's
queueing calls (train_epoch_scanned_async, evaluate_scanned_async) per
step they queue."""


def read(ctx):
    steps = ctx.get("queued_steps")
    return 1e3 * ctx["host_s"] / steps if steps else None
