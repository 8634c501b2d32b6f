"""device_idle_share.online: ``device_idle_share``
(``metrics/device_idle_share.py``, read the same way) in the online
cells, where it moves ``qps.online``."""

from perfbench.bench.registry import metric_reader

_BASE = metric_reader("device_idle_share")
SOURCE, UNIT, BETTER = _BASE.SOURCE, _BASE.UNIT, _BASE.BETTER
LAYER = _BASE.LAYER
MOVES = "qps.online"
read = _BASE.read
