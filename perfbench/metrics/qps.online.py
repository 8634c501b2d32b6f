"""qps.online: ``qps`` (``metrics/qps.py``, read the same way) in the
online cells, whose host-paced calls spread more run to run than the
bulk cells' and so are held to a bound of their own."""

from perfbench.bench.registry import metric_reader

_BASE = metric_reader("qps")
SOURCE, UNIT, BETTER = _BASE.SOURCE, _BASE.UNIT, _BASE.BETTER
read = _BASE.read
