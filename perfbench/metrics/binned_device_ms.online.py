"""binned_device_ms.online: ``binned_device_ms``
(``metrics/binned_device_ms.py``, read the same way) in the online
cells, where it moves ``qps.online``."""

from perfbench.bench.registry import metric_reader

_BASE = metric_reader("binned_device_ms")
SOURCE, UNIT, BETTER = _BASE.SOURCE, _BASE.UNIT, _BASE.BETTER
LAYER = _BASE.LAYER
MOVES = "qps.online"
read = _BASE.read
