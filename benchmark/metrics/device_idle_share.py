"""device_idle_share (%): the share of the traced slice in which no
operation ran on the device: 1 - the union of the kernel, copy and set
intervals over the slice's length."""


def read(ctx):
    if not ctx.records_ok or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s() / ctx.slice.window_s)
