"""Share of the traced step in which no kernel ran on the SMs
(1 - union of the kernels' intervals / the traced stretch), in %. The
copy engines' copies and fills count as idle: they leave the SMs free."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.kernel_busy_s / tr.window_s)
