"""idle_share: the device, the share of the traced sub-window in which
nothing ran on it, in percent."""


def read(ctx):
    win = ctx.get("trace")
    if win is None or win.busy_s <= 0:
        return None
    return 100.0 * (1.0 - win.busy_s / win.wall_s)
