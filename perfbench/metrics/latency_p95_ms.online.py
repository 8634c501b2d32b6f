"""latency_p95_ms.online: ``latency_p95_ms`` (``metrics/latency_p95_ms.py``,
read the same way) in the online cells, under a bound of their own."""

from perfbench.bench.registry import metric_reader

_BASE = metric_reader("latency_p95_ms")
SOURCE, UNIT, BETTER = _BASE.SOURCE, _BASE.UNIT, _BASE.BETTER
read = _BASE.read
