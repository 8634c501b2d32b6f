"""setup_s: process start to the window's start (host clock): imports,
the card's context, the kernel library, data, build and warm-up."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"


def read(run):
    return run.setup_s
