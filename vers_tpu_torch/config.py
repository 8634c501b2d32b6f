"""Configuration dataclasses for vers_tpu_torch (the slice ported so
far: the flat, IVFFlat and RP-forest indexes; fields and defaults as in
``vers_tpu.config``).

The reference has no config system at all — every hyperparameter is a
positional literal at a call site (e.g. HNSW ``(12, 100, 32, 24)`` at
`vers/src/main.rs:70-79`). We promote them to explicit dataclasses so
benchmarks / CLIs can sweep them, while keeping the same positional
constructor signatures on the index classes for parity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FlatConfig:
    """Exact brute-force index (the `search_exhaustive` equivalent,
    `vers/src/utils.rs:68-82`, promoted to a first-class index)."""

    metric: str = "sq_euclidean"  # or "cosine"
    dtype: str = "float32"  # compute dtype for the distance matmul
    chunk_size: int = 16384  # corpus rows per fused-scan step
    # Search engine: "auto" (alias of "exact"), "exact" (the
    # distance-top-k kernel on a CUDA tensor, its plain torch version
    # on a CPU tensor), "approx" (per-chunk top-k, then a top-k of the
    # candidates; exact per chunk here, ROADMAP queue 3) or "bucket"
    # (the bucket-min scan and the values top-k kernels; recall < 1
    # where two neighbours share a bucket).
    engine: str = "auto"
    # "bucket" only: rescore a 32-wide shortlist exactly in f32.
    bucket_rescore: bool = False


@dataclasses.dataclass(frozen=True)
class IVFFlatConfig:
    """IVFFlat: k-means partitioning + nearest-cluster scan
    (`vers/src/indexes/ivfflat.rs`)."""

    num_clusters: int = 64
    num_attempts: int = 2  # random restarts, best by k-means cost
    max_iterations: int = 10  # Lloyd iteration cap
    # The reference has no nprobe: its search adaptively scans more
    # clusters only while fewer than top_k candidates were found
    # (`ivfflat.rs:166-195`). nprobe=0 selects that adaptive behavior:
    # exactly on the single-query parity path (`search_approximate`),
    # and on the batched path via per-query probe depth — each query
    # probes just enough nearest clusters for their live-member sum
    # (capped at top_k per cluster, like the walk) to reach top_k.
    # nprobe>=1 scans a fixed number of nearest clusters for every
    # query (the BASELINE.json config 4 sweep).
    nprobe: int = 0
    seed: int = 0
    dtype: str = "float32"
    # matmul precision of the batched scan. The packed-scan kernel
    # ("auto" / "pallas") always computes f32-exact distances, whatever
    # this says, as the JAX package's kernel does; the plain version
    # ("xla") exists only at "highest" (TF32 off) and raises otherwise.
    precision: str = "highest"
    # batched-search engine: "auto" / "pallas" = the packed-scan kernel
    # on a CUDA tensor (its plain version on a CPU tensor), with
    # top_k > 128 routed to the plain version as in the JAX package;
    # "xla" = always the plain version.
    engine: str = "auto"


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Random-hyperplane projection forest (Annoy-style), called "LSH"
    in the reference (`vers/src/indexes/lsh.rs`)."""

    num_trees: int = 8
    max_node_size: int = 100
    seed: int = 0
    dtype: str = "float32"
    # batched-search engine: "auto" = the packed-scan kernel on a CUDA
    # tensor when top_k <= 128, else its plain version; "pallas" = the
    # kernel (its plain version on a CPU tensor, and for top_k > 128);
    # "xla" = always the plain version.
    engine: str = "auto"
