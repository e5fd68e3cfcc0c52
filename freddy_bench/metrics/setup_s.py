"""``setup_s``: the process's age when the window opens (host clock):
import, data, index build, server, fleet and warm-up."""


def read(ctx):
    return ctx.setup_s
