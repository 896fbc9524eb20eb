"""Seconds from the process's start to the window's start: imports, data
made from the seed, the program built and warmed (a checkout's first run
also builds the kernels)."""


def read(ctx):
    return ctx["setup_s"]
