"""graph_replay_share: the share of the traced slice's calls that the
program replayed from a CUDA graph: its ``vers/graph.replay`` spans over
all its outcome spans (``graph.replay``, ``graph.capture``,
``graph.eager``). None without the program's outcome spans."""

from perfbench.bench.stages import spans

SOURCE, UNIT, BETTER = "host_clock", "fraction", "higher"
LAYER = "graphs.py"
MOVES = "qps"

OUTCOMES = ("graph.replay", "graph.capture", "graph.eager")


def read(run):
    n = {o: len(spans(run.trace, o)) for o in OUTCOMES}
    total = sum(n.values())
    return n["graph.replay"] / total if total else None
