"""The device's peak of allocated memory from the window's start on (GiB)."""


def read(ctx):
    return ctx["peak_mem_bytes"] / 2**30
