"""Configuration dataclasses for vers_tpu_torch (the flat, IVFFlat,
RP-forest and HNSW indexes; fields and defaults as in
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


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """HNSW graph index (`vers/src/indexes/hnsw.rs`). Built on the host
    one node at a time (``build_index``) or in waves on the index's
    device (``build_index_batched``); queries run as a batched beam
    search on the device. Fields and defaults are the JAX package's:
    they select the same graphs and the same search behaviour."""

    num_layers: int = 8
    ef_construction: int = 100
    ef_search: int = 32
    num_neighbours: int = 16  # M; layer 0 uses 2*M (`hnsw.rs:400-404`)
    seed: int = 0
    dtype: str = "float32"
    # Cap on the padded adjacency width of the device beam. None: the
    # widest row of each layer.
    max_degree: Optional[int] = None
    # dtype of the beam's navigation table: "bfloat16" (half the gather
    # bytes of "float32"; products exact, sums in f32; the final top-k
    # is rescored in f32), "float32", or "int8" (symmetric per-row
    # quantization, round(v / absmax * 127) with f32 scales absmax / 127;
    # a quarter of f32's bytes, the query rounded to bf16, rescored in
    # f32). Where the inline table is on (nav_inline_dp below), "int8"
    # becomes "bfloat16": the inline beam's refine reads bf16 rows.
    nav_dtype: str = "bfloat16"
    # Neighbourhood-inlined navigation (ops/beam_inline.py): the device
    # cache also holds, per node, its layer-0 neighbours' dp-dim
    # PCA-projected bf16 vectors side by side, and the layer-0 beam
    # gathers Q*expand wide rows a step instead of Q*expand*deg thin
    # ones. "auto" (default): on at >= 200k rows under the scan router,
    # the layer-0 gather width capped at min(max_degree or 32, 32)
    # (index/hnsw.py INLINE_DEG_CAP) and dp the larger of 64, 32 whose
    # table fits ``inline_hbm_budget_gb``; else the classic gathers.
    # None/0: classic gathers; an int forces that dp (and leaves
    # max_degree alone).
    nav_inline_dp: Optional[object] = "auto"
    # Device-memory budget of the (n_pad, cap*dp) bf16 inline table
    # when nav_inline_dp="auto" picks dp (4 GiB at 1M x 32 x 64).
    inline_hbm_budget_gb: float = 4.5
    # Exact-refine width of the inline beam: each step scores the
    # candidates in projected space, keeps this many, and ranks them by
    # their full-dim bf16 distances, so the beam keeps exact order.
    # None -> 2*ef; 0 -> pure projected navigation.
    nav_inline_refine: Optional[int] = None
    # Beam width of the routing layers (route_mode="beam"). The
    # reference uses ef_search on every layer (`hnsw.rs:526-536`); a
    # routing layer only has to land the entry of the layer below.
    # None -> ef_search everywhere (PARITY.md D13).
    ef_route: Optional[int] = 8
    # Best unexpanded beam entries expanded a step. None -> 8 on the
    # classic gather beam and ``add``'s insertion beams, 4 on the inline
    # beam; an int forces that value everywhere. (The wave build takes
    # its own ``expand``, 8.)
    beam_expand: Optional[int] = None
    # Cap on the query beam's steps. None -> max(4*ef, 64) on the
    # classic beam, ceil(ef/expand) on the inline beam.
    beam_steps: Optional[int] = None
    # Batched-query routing. "scan" (default): one exact scan of the
    # layer-1 members (every node of a layer >= 1 is one of them) picks
    # the top ``route_seeds`` entries of the layer-0 beam; on a CUDA
    # index the scan is kernel A. "beam": the reference-shaped greedy
    # descent through layers L-2..1 (PARITY.md D13).
    route_mode: str = "scan"
    # Entry seeds of the routing scan. 0 -> min(ef_search, 8). On a
    # CUDA index at most 128 (kernel A's k; more raises).
    route_seeds: int = 0
