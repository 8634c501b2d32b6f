"""recall_at_10: the mean share of the exact 10 nearest rows (all rows,
worked out by the plain reference in f64 once the window has closed)
among the 10 rows served, over whole kept batches of the window that
together hold the cell's whole pool of queries."""

SOURCE, UNIT, BETTER = "host_clock", "fraction", "higher"


def read(run):
    return run.judged.get("recall_at_10")
