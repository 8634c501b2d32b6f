"""stubflat_rank_ms, for the tests only: what a new ``metrics/<name>.py``
of another index reads. Device ms a call of the ``stubflat.rank`` stage,
whose marker index follows the binned search's five (``bench/stages.py``),
read with the stub index's own stage table. None without its markers."""

from perfbench.bench.stages import STAGES, stage_ms

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "stub index (stage rank)"
MOVES = "qps"

STUB_STAGES = STAGES + ("stubflat.scan", "stubflat.rank", "stubflat.end")


def read(run):
    return stage_ms(run.trace, "stubflat.rank", stages=STUB_STAGES)
