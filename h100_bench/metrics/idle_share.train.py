"""idle_share.train: the share of the traced window in which no kernel,
copy or memset ran on the device, 100 · (1 − busy / window)."""


def read(ctx):
    win = ctx.win
    if not win.events or win.window_s <= 0:
        return None
    return 100.0 * (1.0 - win.busy_s / win.window_s)
