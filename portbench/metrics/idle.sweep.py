"""Share of the traced sweep's window with no operation on the device (%)."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
