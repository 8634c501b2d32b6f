"""Logging and per-index stats (counterpart of ``vers_tpu.utils.logging``):
a standard logger, its level from ``VERS_LOG``, and a small stats dict per
index."""

from __future__ import annotations

import logging
import os


def get_logger(name: str = "vers_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        log.addHandler(handler)
        log.setLevel(os.environ.get("VERS_LOG", "WARNING").upper())
    return log


def index_stats(index) -> dict:
    """Type, dim, and per kind: HNSW's nodes per layer
    (`hnsw.rs:480-485`); IVFFlat's centroids and cluster sizes (from the
    host ids, or for a device-built index from its layout: the occupied
    ``true_sizes_host`` of a slacked layout, else ``sizes_host``, the
    keys of ``ops/binned.make_layout`` and ``slacken_layout``); the
    forest's trees and leaves per tree."""
    stats = {"type": type(index).__name__, "dim": getattr(index, "dim", None)}
    if hasattr(index, "get_num_nodes_in_layers"):
        stats["num_nodes_per_layer"] = index.get_num_nodes_in_layers()
    if hasattr(index, "num_centroids"):
        stats["num_centroids"] = index.num_centroids
        if getattr(index, "_ids", None) is not None:
            stats["cluster_sizes"] = [len(c) for c in index._ids]
        elif getattr(index, "_layout", None) is not None:
            sizes = index._layout.get(
                "true_sizes_host", index._layout["sizes_host"])
            stats["cluster_sizes"] = [int(s) for s in sizes]
    if hasattr(index, "_trees"):
        stats["num_trees"] = len(index._trees)
        stats["buckets_per_tree"] = [t.num_buckets for t in index._trees]
    return stats
