"""What one run hands the metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perfbench.bench.trace import Trace
from perfbench.bench.traffic import Window


@dataclass
class Run:
    batch: int                     # queries a call
    window: Window                 # the measured window's calls
    setup_s: float                 # process start to the window's start
    build_s: Optional[float] = None        # build, then the first call drained
    build_index_s: Optional[float] = None  # the build alone, synchronised
    # (each a mean where the driver times more than one build)
    enqueue_s: List[float] = field(default_factory=list)  # each call into the system
    judged: Dict[str, float] = field(default_factory=dict)  # the check's numbers
    trace: Optional[Trace] = None
    # the work of a call that a roofline reader counts, by pool batch, in
    # the form that reader defines (kernel_b_roofline: packed_scan_bound's
    # arguments); None where the driver counts none
    work: Optional[List[dict]] = None
    pool_batches: int = 1
    memory_peak_bytes: int = 0
