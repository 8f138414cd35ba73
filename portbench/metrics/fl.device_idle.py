"""Share of the traced window with no operation on the card
(torch.profiler's kernels, copies and sets)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
