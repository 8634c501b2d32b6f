"""build_s: the index's build on the corpus already on the card, then
the cell's first search call, drained to the host (host clock, ending in
a synchronise): the time until a new index answers; the mean over the
traffic's ``builds`` builds of one run."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"


def read(run):
    return run.build_s
