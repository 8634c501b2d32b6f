"""HNSW index — counterpart of ``vers_tpu.index.hnsw``; the reference is
`vers/src/indexes/hnsw.rs`.

Construction either follows the reference one node at a time on the
host with numpy (``build_index``, a faithful port including its quirks,
noted inline), or runs wave-parallel on the index's device
(``build_index_batched`` / ``build_index_device``,
``ops/hnsw_build.py``). Queries run as a batched beam search over padded
per-layer adjacency tensors on the device (``ops/beam.py``,
``ops/beam_inline.py``); the default router scans the layer-1 members
exactly with kernel A on a CUDA index.

Distances are cosine distance ``1 - dot`` on (assumed) normalized
vectors — parity with `cosine_similarity_simd` (`base.rs:158-223`).

Quirk parity (all preserved, see `search_approximate`):
- the entry point is an arbitrary node of the top layer
  (`hnsw.rs:516`); we use the first-inserted for determinism,
- the top layer itself is never searched at query time; with
  num_layers == 1 the reference returns no results (`hnsw.rs:526`),
- the neighbour-selection loop admits up to M+1 neighbours
  (`hnsw.rs:126` checks ``> num_neighbours`` after adding),
- layer 0 uses 2*M neighbours (`hnsw.rs:400-404`).

With no ``device`` an index lives on the first CUDA card
(``core.resolve_device``); ``device="cpu"`` runs the plain versions.
``nav_dtype="int8"`` is not ported and raises NotImplementedError.
"""

from __future__ import annotations

import heapq
import math
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vers_tpu_torch.config import HNSWConfig
from vers_tpu_torch.core import (
    as_query_matrix,
    device_id_map,
    resolve_device,
    round_up,
)
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import (
    AdjacencyItem,
    DistanceCandidatePair,
    SearchResult,
)
from vers_tpu_torch.ops.beam import full_descent, full_descent_scan


def resolve_beam_expand(config, inline_on: bool = False) -> int:
    """``beam_expand=None`` -> context default: 8 on the classic gather
    beam and construction beams, 4 on the inline beam. An explicit int
    wins everywhere."""
    be = getattr(config, "beam_expand", None)
    if be:
        return max(1, int(be))
    return 4 if inline_on else 8


def auto_inline_dp(config, n_rows: int, n_pad: int, deg: int):
    """Size-aware resolution of ``nav_inline_dp="auto"``: the inline
    table pays where the layer-0 row-gather bound dominates (>= 200k
    rows), costs (n_pad, deg*dp) bf16 of device memory, and only the
    scan router feeds the inline beam. dp = the larger of (64, 32) whose
    table fits ``inline_hbm_budget_gb``; None = classic gathers."""
    if n_rows < 200_000:
        return None
    if getattr(config, "route_mode", "scan") != "scan":
        return None
    budget = int(
        float(getattr(config, "inline_hbm_budget_gb", 4.5)) * (1 << 30)
    )
    for dp in (64, 32):
        if n_pad * deg * dp * 2 <= budget:
            return dp
    return None


# Gather-degree cap applied by the auto nav policy when the inline beam
# engages (the JAX package's measured operating point runs
# max_degree=32 with dp=64). Truncation keeps the FIRST 32 neighbours
# (insertion order, the reference's Vec order).
INLINE_DEG_CAP = 32


def auto_nav_policy(config, n_rows: int, n_pad: int):
    """Joint resolution of (adjacency gather cap, inline dp) for
    ``nav_inline_dp="auto"``. Returns ``(cap, dp)``:

    - explicit ``nav_inline_dp`` (int/None/0): the user's knobs win —
      ``(config.max_degree, that value)``.
    - auto, small corpus (<200k rows) or beam routing: classic gathers,
      no cap beyond the user's.
    - auto at scale: cap the layer-0 gather width at
      ``min(max_degree or INLINE_DEG_CAP, INLINE_DEG_CAP)`` and pick
      the largest dp of (64, 32) whose (n_pad, cap*dp) bf16 table fits
      ``inline_hbm_budget_gb``. If neither fits, no cap, no table.

    The reference's users pass four ints (`main.rs:70-79`); this policy
    picks the operating point from those same four ints."""
    user_cap = getattr(config, "max_degree", None)
    dp_cfg = getattr(config, "nav_inline_dp", None)
    if dp_cfg != "auto":
        return user_cap, (int(dp_cfg) if dp_cfg else None)
    if n_rows < 200_000 or getattr(config, "route_mode", "scan") != "scan":
        return user_cap, None
    cap = min(int(user_cap), INLINE_DEG_CAP) if user_cap else INLINE_DEG_CAP
    budget = int(
        float(getattr(config, "inline_hbm_budget_gb", 4.5)) * (1 << 30)
    )
    for dp in (64, 32):
        if n_pad * cap * dp * 2 <= budget:
            return cap, dp
    return user_cap, None


class _Layer:
    __slots__ = ("adjacency",)

    def __init__(self):
        self.adjacency: Dict[int, AdjacencyItem] = {}


class HNSWIndex(Index):
    def __init__(
        self,
        ef_construction: int,
        ef_search: int,
        num_layers: int,
        num_neighbours: int,
        config: Optional[HNSWConfig] = None,
        seed: int = 0,
        device=None,
    ):
        """Parity signature with `HNSWIndex::new` (`hnsw.rs:310-333`),
        plus the device the index serves from."""
        self.config = config or HNSWConfig(
            num_layers=num_layers,
            ef_construction=ef_construction,
            ef_search=ef_search,
            num_neighbours=num_neighbours,
            seed=seed,
        )
        if getattr(self.config, "nav_dtype", "bfloat16") == "int8":
            raise NotImplementedError(
                'HNSWConfig(nav_dtype="int8") is not ported (ROADMAP 1.8); '
                'use "bfloat16" or "float32"')
        self.device = resolve_device(device)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self.num_neighbours = int(num_neighbours)
        self.layers: List[_Layer] = [_Layer() for _ in range(num_layers)]
        # parity with `hnsw.rs:323`: 1/ln(M)
        self.layer_multiplier = 1.0 / math.log(num_neighbours)
        # id_to_vec is a contiguous matrix + id->row map so the build's
        # hot loop (neighbour distance evals) is one numpy gather+gemv
        self._vecs = np.zeros((0, 0), np.float32)
        self._rows_used = 0
        self._id_row: Dict[int, int] = {}
        self._rng = np.random.default_rng(self.config.seed)
        self.dim = 0
        self._device_cache = None
        # wave-build fast path: per-layer (member_ids, adj, dist) numpy
        # triples pending conversion into self.layers dicts; the device
        # query path consumes them directly and the host dicts
        # materialize lazily (save/single-query only; `add` patches the
        # pending arrays + device cache in place)
        self._pending_graph = None
        self._pending_maps = None
        self._pending_bufs = None
        # device-resident build (build_index_device): the (n_pad, d)
        # f32 corpus lives on the device and ids are identity rows; the
        # host table downloads lazily only for host-path consumers
        self._corpus_dev = None
        # a PCA basis carried over by from_numpy (else computed)
        self._inline_basis = None
        self._last_add_patch = None
        # seconds of the last batched build: host and device apart
        self.build_seconds: dict = {}

    # -- id_to_vec facade ------------------------------------------------

    @property
    def id_to_vec(self) -> Dict[int, np.ndarray]:
        """Dict view (insertion-ordered) for parity/serialization paths."""
        self._ensure_host_vecs()
        return {nid: self._vecs[r] for nid, r in self._id_row.items()}

    def _ensure_host_vecs(self) -> None:
        """Download a device-resident corpus into the host vector table
        (lazy: only host-path consumers — save/add/single-query — pay
        the transfer)."""
        if self._corpus_dev is None or self._vecs.shape[0] >= self._rows_used:
            return
        self._vecs = self._corpus_dev[: self._rows_used].cpu().numpy().copy()

    def _set_vec(self, nid: int, vec: np.ndarray) -> None:
        self._ensure_host_vecs()
        # any vector write invalidates the device corpus copy
        self._corpus_dev = None
        vec = np.asarray(vec, dtype=np.float32).reshape(-1)
        if not self.dim:
            self.dim = vec.shape[0]
        if self._vecs.shape[1] != self.dim:
            self._vecs = np.zeros((16, self.dim), np.float32)
        row = self._id_row.get(nid)
        if row is None:
            if self._rows_used >= self._vecs.shape[0]:
                grown = np.zeros(
                    (max(16, self._vecs.shape[0] * 2), self.dim), np.float32
                )
                grown[: self._rows_used] = self._vecs[: self._rows_used]
                self._vecs = grown
            row = self._rows_used
            self._rows_used += 1
            self._id_row[nid] = row
        self._vecs[row] = vec

    def _vec(self, nid: int) -> np.ndarray:
        self._ensure_host_vecs()
        return self._vecs[self._id_row[nid]]

    # -- host-side construction (faithful port) -------------------------

    @staticmethod
    def _dist(a: np.ndarray, b: np.ndarray) -> float:
        return float(1.0 - np.dot(a, b))

    def _layer_search(
        self, layer: _Layer, entry_id: int, query: np.ndarray, ef: int
    ) -> List[DistanceCandidatePair]:
        """Port of `HNSWLayer::search` (`hnsw.rs:242-307`): BFS queue +
        ef-bounded max-heap. Returns candidates in DESCENDING distance
        order (largest first), like the reference's unfold-pops."""
        self._ensure_host_vecs()
        queue = deque([entry_id])
        visited = set()
        # max-heap via negated distances: (-dist, tie, id)
        heap: List[Tuple[float, int, int]] = []
        tie = 0
        heapq.heappush(
            heap, (-self._dist(self._vec(entry_id), query), tie, entry_id)
        )
        id_row = self._id_row
        vecs = self._vecs
        while queue:
            node = queue.popleft()
            visited.add(node)
            adj = layer.adjacency.get(node)
            if adj is None:
                continue
            fresh = [nb for nb in adj.neighbours if nb not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            rows = [id_row[nb] for nb in fresh]
            dists = 1.0 - vecs[rows] @ query  # batched neighbour evals
            for nb, d in zip(fresh, dists):
                d = float(d)
                if len(heap) < ef:
                    tie += 1
                    queue.append(nb)
                    heapq.heappush(heap, (-d, tie, nb))
                elif d < -heap[0][0]:
                    tie += 1
                    queue.append(nb)
                    heapq.heapreplace(heap, (-d, tie, nb))
        out = []
        while heap:
            nd, _, nid = heapq.heappop(heap)
            out.append(DistanceCandidatePair(nid, -nd))
        return out  # descending distance

    def _heuristic_neighbour_selection(
        self,
        target_node: int,
        candidates_desc: List[DistanceCandidatePair],
        m: int,
    ) -> List[DistanceCandidatePair]:
        """Port of `_heuristic_neighbour_selection` (`hnsw.rs:104-164`),
        including the off-by-one that admits m+1 neighbours."""
        neighbours: List[DistanceCandidatePair] = []
        nbr_rows: List[int] = []
        for i in range(len(candidates_desc) - 1, -1, -1):  # closest first
            if len(neighbours) > m:
                break
            c = candidates_desc[i]
            if c.candidate_id == target_node:
                continue
            row = self._id_row[c.candidate_id]
            if neighbours:
                # batched: d(c, r) for all r in R; reject if c is closer
                # to ANY current neighbour than to the target
                d_to_nbrs = 1.0 - self._vecs[nbr_rows] @ self._vecs[row]
                if not bool(np.any(c.distance > d_to_nbrs)):
                    neighbours.append(c)
                    nbr_rows.append(row)
            else:
                neighbours.append(c)
                nbr_rows.append(row)
        return neighbours

    def _add_edge(self, layer: _Layer, u: int, v: DistanceCandidatePair) -> None:
        """Undirected edge insert (`hnsw.rs:49-82`)."""
        for a, b in ((u, v.candidate_id), (v.candidate_id, u)):
            item = layer.adjacency.get(a)
            if item is None:
                item = AdjacencyItem()
                layer.adjacency[a] = item
            item.insert(b, v.distance)

    def _trim_neighbours(
        self, layer: _Layer, selected: List[DistanceCandidatePair], m: int
    ) -> None:
        """Port of `_trim_neighbours` (`hnsw.rs:166-198`)."""
        for nb in selected:
            item = layer.adjacency[nb.candidate_id]
            if len(item) > m:
                vecs_desc = item.consume_heap_to_vec()
                updated = self._heuristic_neighbour_selection(
                    nb.candidate_id, vecs_desc, m
                )
                layer.adjacency[nb.candidate_id] = AdjacencyItem.create_from_pairs(
                    updated
                )

    def _layer_add_node(
        self,
        layer: _Layer,
        candidates_desc: List[DistanceCandidatePair],
        target: int,
        m: int,
    ) -> None:
        """Port of `add_node` (`hnsw.rs:200-240`)."""
        if not candidates_desc:
            layer.adjacency[target] = AdjacencyItem()
            return
        selected = self._heuristic_neighbour_selection(target, candidates_desc, m)
        for nb in selected:
            self._add_edge(layer, target, nb)
        self._trim_neighbours(layer, selected, m)

    def _get_insertion_layer(self) -> int:
        """Port of `get_insertion_layer` (`hnsw.rs:335-346`)."""
        u = float(self._rng.random())
        u = max(u, 1e-12)
        l = int(-math.log(u) * self.layer_multiplier)
        return min(l, len(self.layers) - 1)

    def _add_node(self, embedding: np.ndarray, embedding_id: int) -> None:
        """Port of `_add_node` (`hnsw.rs:348-432`)."""
        emb = np.asarray(embedding, dtype=np.float32).reshape(-1)
        if not self.dim:
            self.dim = emb.shape[0]
        self._set_vec(embedding_id, emb)
        self._device_cache = None

        top_layer = self.layers[-1]
        insertion_layer = self._get_insertion_layer()

        if top_layer.adjacency:
            entry = next(iter(top_layer.adjacency))
            for layer_idx in range(len(self.layers) - 1, insertion_layer, -1):
                candidates = self._layer_search(
                    self.layers[layer_idx], entry, emb, self.ef_construction
                )
                entry = candidates[-1].candidate_id  # best = last (desc)
            for layer_idx in range(insertion_layer, -1, -1):
                layer = self.layers[layer_idx]
                candidates = self._layer_search(
                    layer, entry, emb, self.ef_construction
                )
                m = (
                    2 * self.num_neighbours
                    if layer_idx == 0
                    else self.num_neighbours
                )
                self._layer_add_node(layer, list(candidates), embedding_id, m)
                entry = candidates[-1].candidate_id
        else:
            # first node joins every layer (`hnsw.rs:417-429`)
            for layer in self.layers:
                self._layer_add_node(layer, [], embedding_id, self.num_neighbours)

    def create(self, vectors: np.ndarray) -> None:
        """Parity with `create` (`hnsw.rs:434-438`)."""
        for idx, vec in enumerate(np.asarray(vectors, dtype=np.float32)):
            self._add_node(vec, idx)

    @classmethod
    def build_index(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        vectors: np.ndarray,
        seed: int = 0,
        device=None,
    ) -> "HNSWIndex":
        """Parity signature with `build_index` (`hnsw.rs:440-478`): the
        reference's sequential build, on the host."""
        index = cls(ef_construction, ef_search, num_layers, num_neighbours,
                    seed=seed, device=device)
        vectors = np.asarray(vectors, dtype=np.float32)
        # parity: id_to_vec is fully populated up front (`hnsw.rs:453-455`)
        for idx, vec in enumerate(vectors):
            index._set_vec(idx, vec)
        if vectors.size:
            index.dim = vectors.shape[1]
        for idx, vec in enumerate(vectors):
            index._add_node(vec, idx)
        return index

    @classmethod
    def build_index_batched(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        vectors: np.ndarray,
        seed: int = 0,
        wave_cap: int | str = "auto",
        device=None,
        **build_kwargs,
    ) -> "HNSWIndex":
        """Wave-parallel construction on the index's device
        (``ops/hnsw_build``): same parameters and layer statistics as
        ``build_index`` but built with batched beam searches instead of
        the reference's sequential host loop. The graph differs node by
        node (waves freeze the graph within a batch). Extra kwargs
        forward to ``build_graph``. ``build_seconds`` records the
        upload and the waves (device, ending in a sync) and the host
        copy of the graph apart."""
        from vers_tpu_torch.ops.hnsw_build import build_graph

        index = cls(ef_construction, ef_search, num_layers, num_neighbours,
                    seed=seed, device=device)
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.size:
            # bulk vector table install (no per-row _set_vec loop)
            index._vecs = vectors.copy()
            index._rows_used = vectors.shape[0]
            index._id_row = dict(zip(range(vectors.shape[0]),
                                     range(vectors.shape[0])))
            index.dim = vectors.shape[1]
        t0 = time.perf_counter()
        timings: dict = {}
        _, index._pending_graph = build_graph(
            vectors, num_layers, ef_construction, num_neighbours,
            seed=seed, wave_cap=wave_cap, as_arrays=True,
            device=index.device, timings=timings, **build_kwargs,
        )
        index._record_build(time.perf_counter() - t0, timings)
        return index

    @classmethod
    def build_index_device(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        corpus: torch.Tensor,
        n_valid: Optional[int] = None,
        seed: int = 0,
        wave_cap: int | str = "auto",
        **build_kwargs,
    ) -> "HNSWIndex":
        """Device-resident build: ``corpus`` is an (n_pad, d) f32 tensor
        already on its device (rows padded to a multiple of 128; pass
        ``n_valid`` for the live row count — padding rows are ignored).
        The wave builder consumes it in place and the serving cache
        reuses it as the f32 rescore table, so the corpus never crosses
        to the host. Host-path consumers (save_index / add /
        search_approximate) download it lazily. The index lives on the
        corpus's device."""
        from vers_tpu_torch.ops.hnsw_build import build_graph

        if not isinstance(corpus, torch.Tensor) or corpus.ndim != 2:
            raise ValueError("corpus must be an (n_pad, d) torch tensor")
        if corpus.shape[0] % 128:
            raise ValueError(
                "device corpus rows must be padded to a multiple of 128"
            )
        index = cls(ef_construction, ef_search, num_layers, num_neighbours,
                    seed=seed, device=corpus.device)
        n = int(n_valid) if n_valid is not None else int(corpus.shape[0])
        index.dim = int(corpus.shape[1])
        index._rows_used = n
        index._id_row = dict(zip(range(n), range(n)))
        index._corpus_dev = corpus.float()
        t0 = time.perf_counter()
        timings: dict = {}
        _, index._pending_graph = build_graph(
            index._corpus_dev, num_layers, ef_construction, num_neighbours,
            seed=seed, wave_cap=wave_cap, n_valid=n, as_arrays=True,
            timings=timings, **build_kwargs,
        )
        index._record_build(time.perf_counter() - t0, timings)
        return index

    def _record_build(self, total_s: float, timings: dict) -> None:
        dev_s = timings.get("upload_s", 0.0) + timings.get("waves_s", 0.0)
        self.build_seconds = dict(
            upload_s=timings.get("upload_s", 0.0),
            waves_s=timings.get("waves_s", 0.0),
            graph_to_host_s=total_s - dev_s,
            waves=timings.get("waves", 0),
            wave_cap=timings.get("wave_cap"),
        )

    @classmethod
    def from_numpy(
        cls,
        vectors: np.ndarray,
        pending_graph,
        ef_construction: int,
        ef_search: int,
        num_layers: int,
        num_neighbours: int,
        config: Optional[HNSWConfig] = None,
        basis: Optional[np.ndarray] = None,
        seed: int = 0,
        device=None,
    ) -> "HNSWIndex":
        """An index over another package's wave-built graph: ``vectors``
        (n, d) with identity ids, ``pending_graph`` the per-layer
        ``(members, adj, dist)`` triples that
        ``build_graph(as_arrays=True)`` returns (``vers_tpu``'s
        ``HNSWIndex._pending_graph``), the four ints, the config and,
        optionally, the (d, dp) PCA basis of the inline table (an
        eigensolver on a covariance summed in another order may flip or
        rotate eigenvectors, so a comparison carries it over).
        Everything is copied."""
        index = cls(ef_construction, ef_search, num_layers, num_neighbours,
                    config=config, seed=seed, device=device)
        vectors = np.array(vectors, dtype=np.float32)
        n = vectors.shape[0]
        index._vecs = vectors
        index._rows_used = n
        index._id_row = dict(zip(range(n), range(n)))
        index.dim = vectors.shape[1] if vectors.ndim == 2 else 0
        index._pending_graph = [
            (np.array(mem, np.int64), np.array(adj, np.int32),
             np.array(dist, np.float32))
            for mem, adj, dist in pending_graph
        ]
        if basis is not None:
            index._inline_basis = np.array(basis, np.float32)
        return index

    def _materialize_layers(self) -> None:
        """Convert a pending wave-build array graph into the host
        adjacency dicts (one pass; called lazily by the host-side
        consumers — save_index, add, search_approximate)."""
        pending, self._pending_graph = self._pending_graph, None
        self._pending_maps = None
        self._pending_bufs = None
        if pending is None:
            return
        for l, (mem, adj, dist) in enumerate(pending):
            layer = self.layers[l]
            valid = (adj >= 0) & np.isfinite(dist)
            for i, gid in enumerate(mem):
                cols = np.nonzero(valid[i])[0]
                item = AdjacencyItem()
                for j in cols:
                    item.insert(int(adj[i, j]), float(dist[i, j]))
                layer.adjacency[int(gid)] = item

    def get_num_nodes_in_layers(self) -> List[int]:
        if self._pending_graph is not None:
            return [len(mem) for mem, _, _ in self._pending_graph]
        return [len(l.adjacency) for l in self.layers]

    # -- Index API -------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Incremental insert (`hnsw.rs:503-508`).

        On a wave-/device-built index (pending array graph, identity
        ids) with ``vec_id`` appending at the end, the FAST path runs:
        one device insertion descent (`ops/beam.insertion_candidates`),
        host-side neighbour selection on the downloaded efc-row
        candidate sets, and in-place patches of the touched device
        adjacency rows — no corpus download, no full-graph
        materialization, no re-upload. Any other case (arbitrary ids,
        dict-graph index) takes the reference-parity host path."""
        emb = np.asarray(embedding, dtype=np.float32).reshape(-1)
        self._last_add_patch = None  # set by the fast path below
        if (
            self._pending_graph is not None
            and vec_id == self._rows_used
            and self._rows_used > 0
            and self.dim == emb.shape[0]
            and self._add_node_device(emb, vec_id)
        ):
            return
        self._materialize_layers()
        self._add_node(emb, vec_id)

    # -- device-side incremental add (no materialization cliff) -----------

    def _ensure_pending_maps(self):
        """Per-layer {global row -> pending row index} maps for the
        fast add path (built once, maintained incrementally)."""
        if self._pending_maps is None:
            self._pending_maps = [
                {int(g): i for i, g in enumerate(mem)}
                for mem, _, _ in self._pending_graph
            ]
        return self._pending_maps

    @staticmethod
    def _select_neighbours_np(cand_i, cand_d, cand_v, m: int, exclude: int):
        """Heuristic neighbour selection (`hnsw.rs:104-164`, incl. the
        m+1-admission quirk) over one downloaded candidate set
        (ascending distance). Returns (ids, dists) lists."""
        sel_ids: List[int] = []
        sel_d: List[float] = []
        sel_rows: List[int] = []
        for j in range(len(cand_i)):
            if len(sel_ids) > m:
                break
            cid = int(cand_i[j])
            if cid < 0 or cid == exclude or not np.isfinite(cand_d[j]):
                continue
            if sel_rows:
                d_to_sel = 1.0 - cand_v[sel_rows] @ cand_v[j]
                if bool(np.any(cand_d[j] > d_to_sel)):
                    continue
            sel_ids.append(cid)
            sel_d.append(float(cand_d[j]))
            sel_rows.append(j)
        return sel_ids, sel_d

    def _pending_insert_layer(
        self, l: int, row: int, sel_ids, sel_d, m: int
    ) -> dict:
        """Append ``row`` to pending layer ``l`` with its selected
        neighbours and commit reverse edges (full rows prune their
        farthest edge — a documented deviation from the reference's
        trim re-selection). Returns {global row -> packed numpy
        adjacency row} device patches."""
        mem, adj, dist = self._pending_graph[l]
        mem = np.asarray(mem, np.int64)
        maps = self._ensure_pending_maps()[l]
        cap = max(m, 1)
        # width >= cap+1 guarantees (a) room for the selection's m+1
        # quirk and (b) a free slot in any reverse row that is still
        # under cap (rows at >= cap edges take the prune path instead)
        target_w = max(len(sel_ids), cap + 1, adj.shape[1])
        n_live = len(mem)
        bufs = self._pending_bufs
        if bufs is None:
            bufs = self._pending_bufs = {}
        b = bufs.get(l)
        if (
            b is None
            or mem.base is not b[0]
            or b[0].shape[0] < n_live + 1
            or b[1].shape[1] < target_w
        ):
            # (Re)allocate row-slacked buffers; the live arrays in
            # _pending_graph are views into them, so per-add appends are
            # amortized O(1) instead of copying the whole (n, width)
            # layer tables per insert
            r_cap = n_live + max(256, n_live // 4) + 1
            mem_b = np.empty((r_cap,), np.int64)
            mem_b[:n_live] = mem
            adj_b = np.full((r_cap, target_w), -1, np.int32)
            adj_b[:n_live, : adj.shape[1]] = adj
            dist_b = np.full((r_cap, target_w), np.inf, dist.dtype)
            dist_b[:n_live, : adj.shape[1]] = dist
            bufs[l] = (mem_b, adj_b, dist_b)
        else:
            mem_b, adj_b, dist_b = b
        mem_b[n_live] = row
        adj_b[n_live, :] = -1
        dist_b[n_live, :] = np.inf
        adj_b[n_live, : len(sel_ids)] = sel_ids
        dist_b[n_live, : len(sel_ids)] = sel_d
        mem = mem_b[: n_live + 1]
        adj = adj_b[: n_live + 1]
        dist = dist_b[: n_live + 1]
        maps[row] = n_live
        touched = {row: adj[n_live]}
        for u, du in zip(sel_ids, sel_d):
            r_u = maps.get(int(u))
            if r_u is None:
                continue
            row_adj, row_dist = adj[r_u], dist[r_u]
            valid = row_adj >= 0
            n_valid = int(valid.sum())
            if n_valid < cap:
                slot = int(np.argmin(valid))  # first empty (width > cap)
            else:
                slot = int(
                    np.argmax(np.where(valid, row_dist, -np.inf))
                )
                if du >= float(row_dist[slot]):
                    continue  # farther than every current edge: drop
            row_adj[slot] = row
            row_dist[slot] = du
            touched[int(u)] = row_adj
        self._pending_graph[l] = (mem, adj, dist)
        return touched

    def _patch_device_adj(self, cache, l: int, touched: dict) -> None:
        """Apply {global row -> numpy adjacency row} patches to the
        cached device adjacency of layer ``l`` (one scatter; widens the
        padded degree on demand)."""
        dev = cache["adjs"][l]
        width = int(dev.shape[1])
        need = max(
            (int(np.count_nonzero(a >= 0)) for a in touched.values()),
            default=1,
        )
        widened = need > width
        if widened:
            dev = torch.cat(
                [dev, torch.full((dev.shape[0], need - width), -1,
                                 dtype=dev.dtype, device=dev.device)],
                dim=1,
            )
            width = need
        rows = np.fromiter(touched.keys(), np.int64, len(touched))
        mat = np.full((len(rows), width), -1, np.int32)
        for i, r in enumerate(rows):
            a = touched[int(r)]
            v = a[a >= 0][:width]
            mat[i, : len(v)] = v
        dev[torch.from_numpy(rows).to(dev.device)] = torch.from_numpy(mat).to(
            dev.device)
        cache["adjs"][l] = dev
        if l == 0 and cache.get("inline") is not None:
            self._refresh_inline_rows(cache, rows, widened=widened)

    def _refresh_inline_rows(self, cache, rows, widened: bool) -> None:
        """Keep the inline neighbourhood table consistent after in-place
        layer-0 adjacency patches: recompute the touched rows' blocks
        from the projected table. A degree widening changes the table
        width — rebuild it wholesale (one device pass; rare)."""
        from vers_tpu_torch.ops.beam_inline import build_inline_table

        inline = cache["inline"]
        proj = inline["proj"]
        dp = int(proj.shape[1])
        adj0 = cache["adjs"][0]
        if widened or inline["tab"].shape[1] != adj0.shape[1] * dp:
            inline["tab"] = build_inline_table(proj, adj0, dp)
            return
        n_pad = proj.shape[0]
        r = torch.from_numpy(np.asarray(rows, np.int64)).to(adj0.device)
        a = adj0[r].long()                                  # (t, deg)
        v = proj[a.clamp(0, n_pad - 1)]
        v = v.masked_fill((a < 0)[:, :, None], 0)
        inline["tab"][r] = v.reshape(r.shape[0], -1)

    def _add_node_device(self, emb: np.ndarray, vid: int) -> bool:
        from vers_tpu_torch.ops.beam import insertion_candidates

        cache = self._ensure_device_cache()
        if cache["entry"] is None:
            return False  # no entrypoint: caller takes the host path
        row = self._rows_used
        d = self.dim
        dev = self.device
        # capacity: grow the device tables by one block of 128 rows
        n_pad = int(cache["vecs"].shape[0])
        if row >= n_pad:
            grow = 128

            def grown(t, fill=0):
                return torch.cat([t, torch.full((grow,) + tuple(t.shape[1:]),
                                                fill, dtype=t.dtype,
                                                device=t.device)])

            cache["vecs"] = grown(cache["vecs"])
            cache["vecs_nav"] = grown(cache["vecs_nav"])
            cache["adjs"] = [grown(a, -1) for a in cache["adjs"]]
            if cache.get("inline") is not None:
                inline = cache["inline"]
                inline["proj"] = grown(inline["proj"])
                inline["tab"] = grown(inline["tab"])
        # write the vector; the new row has no incoming edges yet so it
        # is invisible to the descent below
        qrow = torch.from_numpy(emb).to(dev)
        cache["vecs"][row] = qrow
        cache["vecs_nav"][row] = qrow.to(cache["vecs_nav"].dtype)
        if cache.get("inline") is not None:
            from vers_tpu_torch.ops.beam_inline import project_rows

            inline = cache["inline"]
            dp = int(inline["proj"].shape[1])
            inline["proj"][row] = project_rows(qrow[None], inline["basis"], dp)[0]
        if self._corpus_dev is not None:
            self._corpus_dev = cache["vecs"]
        else:
            # host table mirror (raw append; _set_vec would invalidate)
            if row >= self._vecs.shape[0] or self._vecs.shape[1] != d:
                grown_h = np.zeros(
                    (max(16, row * 2, self._vecs.shape[0] * 2), d),
                    np.float32,
                )
                grown_h[:row] = self._vecs[:row]
                self._vecs = grown_h
            self._vecs[row] = emb
        self._id_row[vid] = row
        self._rows_used = row + 1
        # amortized O(1) id-map appends: node_ids stays an exact-length
        # VIEW of a row-slacked buffer; node_ids_dev grows in blocks of
        # 128 (padding rows are never gathered — consumers clip to
        # len(node_ids))
        n_ids = len(cache["node_ids"])
        ibuf = cache.get("_ids_buf")
        if (
            ibuf is None
            or cache["node_ids"].base is not ibuf
            or ibuf.shape[0] < n_ids + 1
        ):
            i_cap = n_ids + max(256, n_ids // 4) + 1
            nb = np.empty((i_cap,), np.int64)
            nb[:n_ids] = cache["node_ids"]
            ibuf = cache["_ids_buf"] = nb
        ibuf[n_ids] = vid
        cache["node_ids"] = ibuf[: n_ids + 1]
        nd = cache["node_ids_dev"]
        if nd is not None and -(2**31) <= vid < 2**31:
            if n_ids >= nd.shape[0]:
                nd = torch.cat([nd, torch.full((128,), -1, dtype=nd.dtype,
                                               device=nd.device)])
            nd[n_ids] = int(vid)
            cache["node_ids_dev"] = nd
        else:
            cache["node_ids_dev"] = device_id_map(cache["node_ids"], dev)

        l_ins = self._get_insertion_layer()
        cand_d, cand_i, cand_v = insertion_candidates(
            qrow[None],
            cache["vecs"],
            cache["vecs_nav"],
            cache["adjs"],
            torch.full((1,), cache["entry"], dtype=torch.int64, device=dev),
            efc=self.ef_construction,
            l_ins=l_ins,
            expand=resolve_beam_expand(self.config),
            steps_cap=getattr(self.config, "beam_steps", None),
        )
        cand_d = cand_d.cpu().numpy()
        cand_i = cand_i.cpu().numpy()
        cand_v = cand_v.cpu().numpy()
        touched0 = {}
        for j, l in enumerate(range(l_ins, -1, -1)):
            m = 2 * self.num_neighbours if l == 0 else self.num_neighbours
            sel_ids, sel_d = self._select_neighbours_np(
                cand_i[j], cand_d[j], cand_v[j], m, exclude=row
            )
            touched = self._pending_insert_layer(l, row, sel_ids, sel_d, m)
            self._patch_device_adj(cache, l, touched)
            if l == 0:
                touched0 = touched
        # layer-1 routing table membership
        if l_ins >= 1 and cache.get("l1_tab") is not None:
            n1 = int(cache["n1"])
            n1_pad = int(cache["l1_members"].shape[0])
            if n1 >= n1_pad:
                cache["l1_members"] = torch.cat(
                    [cache["l1_members"],
                     torch.zeros((8,), dtype=cache["l1_members"].dtype,
                                 device=dev)]
                )
                cache["l1_tab"] = torch.cat(
                    [cache["l1_tab"],
                     torch.zeros((8, d), dtype=cache["l1_tab"].dtype,
                                 device=dev)]
                )
            cache["l1_members"][n1] = row
            cache["l1_tab"][n1] = qrow.to(torch.bfloat16)
            cache["n1"] = n1 + 1
        # rows are views into the pending buffers — read them before
        # the next insert mutates them
        self._last_add_patch = dict(
            row=row, adj0=touched0, l1_added=l_ins >= 1
        )
        return True

    def search_approximate(self, query, top_k: int) -> List[Tuple[int, float]]:
        """Port of `search_approximate` (`hnsw.rs:510-548`), all quirks
        preserved (top layer skipped; empty result if num_layers == 1).
        Runs on the host."""
        self._materialize_layers()
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        top_layer = self.layers[-1]
        if not top_layer.adjacency:
            return []
        entry = next(iter(top_layer.adjacency))
        final: List[DistanceCandidatePair] = []
        for layer_idx in range(len(self.layers) - 2, -1, -1):
            candidates = self._layer_search(
                self.layers[layer_idx], entry, q, self.ef_search
            )
            if layer_idx != 0:
                entry = candidates[-1].candidate_id
            else:
                final = candidates
        final.reverse()  # ascending
        return [(c.candidate_id, c.distance) for c in final[:top_k]]

    # -- batched device query path ----------------------------------------

    @staticmethod
    def _pack_pending_adjs(pending, n_pad: int, cap) -> List[np.ndarray]:
        """Wave-build fast path: adjacency arrives as numpy arrays in
        global==compact ids; no host dicts needed. Vectorized
        left-compaction of each row's valid entries. Returns one numpy
        (n_pad, deg_l) int32 array per layer."""
        adjs = []
        for mem, adj, dist in pending:
            valid = (adj >= 0) & np.isfinite(dist)
            deg = max(int(valid.sum(axis=1).max(initial=0)), 1)
            if cap is not None:
                deg = min(deg, max(int(cap), 1))
            order = np.argsort(~valid, axis=1, kind="stable")
            packed = np.where(
                np.take_along_axis(valid, order, 1),
                np.take_along_axis(adj, order, 1),
                -1,
            )[:, :deg]
            full = np.full((n_pad, deg), -1, np.int32)
            full[mem] = packed
            adjs.append(full)
        return adjs

    def _host_graph_arrays(self, cap_override=None) -> dict:
        """Host-side (numpy) assembly of the serving graph. Returns
        dict(vecs (n_pad, d) f32 numpy or None when the corpus is
        device-resident, adjs [numpy (n_pad, deg_l) int32 per layer,
        compact row ids], l1_rows (n1,) int64 compact rows of layer-1
        members, entry compact row or None, node_ids (n,) int64
        external ids per compact row, n, n_pad)."""
        if self._corpus_dev is not None:
            # device-resident build: corpus already on the device, ids
            # are identity rows — no host table assembly, no download
            n = self._rows_used
            n_pad = int(self._corpus_dev.shape[0])
            node_ids = np.arange(n, dtype=np.int64)
            compact = None  # identity; materialized only if needed
            identity = True
            vecs = None
        else:
            node_list = list(self._id_row.keys())
            compact = {nid: i for i, nid in enumerate(node_list)}
            n = len(node_list)
            n_pad = round_up(max(n, 1), 8)
            vecs = np.zeros((n_pad, self.dim), np.float32)
            if n:
                rows = np.fromiter(self._id_row.values(), np.int64, count=n)
                vecs[:n] = self._vecs[rows]
            identity = node_list == list(range(n))
            node_ids = np.asarray(node_list, dtype=np.int64)
        # config.max_degree caps the padded adjacency width: one
        # high-degree node otherwise widens every gather row of its
        # layer. Truncation keeps the FIRST max_degree neighbours
        # (insertion order — the reference's Vec order). ``cap_override``
        # carries the auto nav policy's joint (cap, dp) decision.
        cap = (
            cap_override
            if cap_override is not None
            else getattr(self.config, "max_degree", None)
        )
        pending = self._pending_graph
        if pending is not None and identity:
            adjs = self._pack_pending_adjs(pending, n_pad, cap)
            top_mem = pending[-1][0]
            entry = int(top_mem[0]) if len(top_mem) else None
            l1_rows = (
                np.asarray(pending[1][0], np.int64)
                if len(pending) > 1
                else np.zeros((0,), np.int64)
            )
        else:
            self._materialize_layers()
            if compact is None:
                compact = {i: i for i in range(n)}
            adjs = []
            for layer in self.layers:
                deg = max((len(a.neighbours) for a in layer.adjacency.values()), default=1)
                deg = max(deg, 1)
                if cap is not None:
                    deg = min(deg, max(int(cap), 1))
                adj = np.full((n_pad, deg), -1, np.int32)
                for nid, item in layer.adjacency.items():
                    row = [compact[x] for x in item.neighbours if x in compact]
                    adj[compact[nid], : len(row[:deg])] = row[:deg]
                adjs.append(adj)
            entry_ext = (
                next(iter(self.layers[-1].adjacency))
                if self.layers[-1].adjacency
                else None
            )
            entry = None if entry_ext is None else compact.get(entry_ext, 0)
            if len(self.layers) > 1:
                l1_rows = np.fromiter(
                    (compact[nid] for nid in self.layers[1].adjacency
                     if nid in compact),
                    np.int64,
                )
            else:
                l1_rows = np.zeros((0,), np.int64)
        return dict(
            vecs=vecs, adjs=adjs, l1_rows=l1_rows, entry=entry,
            node_ids=node_ids, n=n, n_pad=n_pad,
        )

    def _ensure_device_cache(self):
        if self._device_cache is not None:
            return self._device_cache
        # resolve the joint nav policy (gather-degree cap, inline dp)
        # BEFORE packing the graph arrays: the cap changes the padded
        # adjacency width the pack produces
        if self._corpus_dev is not None:
            n_rows = self._rows_used
            n_pad_est = int(self._corpus_dev.shape[0])
        else:
            n_rows = len(self._id_row)
            n_pad_est = round_up(max(n_rows, 1), 8)
        cap, inline_dp = auto_nav_policy(self.config, n_rows, n_pad_est)
        g = self._host_graph_arrays(cap_override=cap)
        dev = self.device
        node_ids = g["node_ids"]
        adjs = [torch.from_numpy(a).to(dev) for a in g["adjs"]]
        vecs_dev = (
            self._corpus_dev
            if g["vecs"] is None
            else torch.from_numpy(g["vecs"]).to(dev)
        )
        if not adjs:
            inline_dp = None
        # navigation table: the beam loop is bound by its row gathers,
        # so bf16 halves the bytes of f32; final results are
        # f32-rescored
        nav_dtype = getattr(self.config, "nav_dtype", "bfloat16")
        vecs_nav = (vecs_dev.to(torch.bfloat16) if nav_dtype == "bfloat16"
                    else vecs_dev)
        # Layer-1 member table for the routing scan (full_descent_scan):
        # the layer-1 nodes' vectors in bf16 (kernel A's bf16-corpus
        # route at precision "default"), zero past n1
        l1_mem = g["l1_rows"]
        n1 = int(l1_mem.size)
        if n1:
            n1_pad = round_up(n1, 8)
            l1_members = torch.from_numpy(
                np.pad(l1_mem, (0, n1_pad - n1)).astype(np.int64)).to(dev)
            l1_tab = vecs_dev[l1_members].to(torch.bfloat16)
            l1_tab[n1:] = 0
        else:
            l1_members = l1_tab = None
        # Neighbourhood-inlined nav table (config.nav_inline_dp,
        # "auto"-resolved above): per node, its layer-0 neighbours'
        # PCA-projected bf16 vectors side by side (ops/beam_inline.py).
        inline = None
        if inline_dp and adjs:
            from vers_tpu_torch.ops.beam_inline import (
                build_inline_table,
                pca_projection,
                project_rows,
            )

            dp = int(inline_dp)
            if self._inline_basis is not None:
                basis = torch.from_numpy(self._inline_basis[:, :dp]).to(dev)
            else:
                basis = pca_projection(vecs_dev, dp)
            proj = project_rows(vecs_dev, basis, dp)
            inline = dict(
                basis=basis,
                proj=proj,
                tab=build_inline_table(proj, adjs[0], dp),
            )
        self._device_cache = dict(
            vecs=vecs_dev,
            vecs_nav=vecs_nav,
            adjs=adjs,
            l1_members=l1_members,
            l1_tab=l1_tab,
            n1=n1,
            node_ids=node_ids,
            node_ids_dev=device_id_map(node_ids, dev),
            entry=g["entry"],
            inline=inline,
            policy=(cap, inline_dp),
        )
        return self._device_cache

    def _search_batch_rows(self, queries, top_k: int):
        """Batched beam search returning (dists (Q,k) f32, COMPACT row
        indices (Q,k) int64, -1 = empty slot) on the index's device —
        id mapping is left to the callers so the host path can use
        int64 external ids."""
        qdev = as_query_matrix(queries, device=self.device)
        q_n = qdev.shape[0]
        cache = self._ensure_device_cache()
        if cache["entry"] is None or len(self.layers) < 2:
            # quirk parity: no entrypoint / single layer -> no results
            return (
                torch.full((q_n, top_k), float("inf"), device=self.device),
                torch.full((q_n, top_k), -1, dtype=torch.int64,
                           device=self.device),
            )
        ef = max(self.ef_search, top_k)
        ef_route = getattr(self.config, "ef_route", None)
        ef_r = max(1, min(ef_route, ef)) if ef_route else ef
        expand = resolve_beam_expand(
            self.config, inline_on=cache.get("inline") is not None
        )
        steps_cap = getattr(self.config, "beam_steps", None)
        rescore = cache["vecs_nav"].dtype != cache["vecs"].dtype
        route_mode = getattr(self.config, "route_mode", "scan")
        if route_mode == "scan" and cache.get("l1_tab") is not None:
            # the routing scan over the layer-1 members (kernel A on the
            # card) + multi-seeded layer-0 beam + f32 rescore
            seeds = getattr(self.config, "route_seeds", 0) or min(ef, 8)
            if cache.get("inline") is not None:
                from vers_tpu_torch.ops.beam_inline import (
                    full_descent_scan_inline,
                )

                inline = cache["inline"]
                refine = getattr(self.config, "nav_inline_refine", None)
                if refine is None:
                    refine = 2 * ef  # exact-retention default
                if steps_cap is None:
                    # the inline beam's auto step cap: ceil(ef/expand)
                    # steps expand ef candidates; the lockstep loop
                    # otherwise runs until every query converges
                    steps_cap = max(1, -(-ef // expand))
                return full_descent_scan_inline(
                    qdev,
                    cache["vecs"],
                    cache["vecs_nav"],
                    inline["basis"],
                    inline["proj"],
                    inline["tab"],
                    cache["adjs"][0],
                    cache["l1_tab"],
                    cache["l1_members"],
                    cache["n1"],
                    top_k=top_k,
                    ef=ef,
                    seeds=seeds,
                    expand=expand,
                    steps_cap=steps_cap,
                    refine_r=int(refine),
                )
            return full_descent_scan(
                qdev,
                cache["vecs"],
                cache["vecs_nav"],
                cache["adjs"][0],
                cache["l1_tab"],
                cache["l1_members"],
                cache["n1"],
                top_k=top_k,
                ef=ef,
                seeds=seeds,
                rescore=rescore,
                expand=expand,
                steps_cap=steps_cap,
            )
        # the whole descent: routing beams + layer-0 beam + f32 rescore
        return full_descent(
            qdev,
            cache["vecs"],
            cache["vecs_nav"],
            cache["adjs"][: len(self.layers) - 1],
            torch.full((q_n,), cache["entry"], dtype=torch.int64,
                       device=self.device),
            top_k=top_k,
            ef=ef,
            ef_r=ef_r,
            rescore=rescore,
            expand=expand,
            steps_cap=steps_cap,
        )

    def search_batch_device(self, queries, top_k: int):
        """Device-resident search: (dists (Q,k) f32, external ids (Q,k)
        int32) tensors on the index's device, no host transfer.

        External ids must fit in int32 (the device id map is int32);
        raises ValueError otherwise — use ``search_batch``, which maps
        rows to int64 ids on the host."""
        bd, bi = self._search_batch_rows(queries, top_k)
        cache = self._ensure_device_cache()
        idmap = cache["node_ids_dev"]
        if idmap is None:
            raise ValueError(
                "external ids exceed int32 range; the device-resident "
                "path cannot map them — use search_batch()"
            )
        n_nodes = len(cache["node_ids"])
        ids = torch.where(bi >= 0, idmap[bi.clamp(0, max(n_nodes - 1, 0))], -1)
        return bd, ids.to(torch.int32)

    def search_batch(self, queries, top_k: int) -> SearchResult:
        bd, bi = self._search_batch_rows(queries, top_k)
        node_ids = self._ensure_device_cache()["node_ids"]  # int64 host
        bi = bi.cpu().numpy()
        ids = np.where(
            bi >= 0,
            node_ids[np.clip(bi, 0, max(len(node_ids) - 1, 0))],
            -1,
        )
        return SearchResult(
            ids=ids.astype(np.int64), distances=bd.cpu().numpy()
        )

    # -- persistence (bincode parity: `hnsw.rs:20-32`, `models.rs:149-153`)

    def save_index(self, file_path: str) -> None:
        self._materialize_layers()
        self._ensure_host_vecs()
        with open(file_path, "wb") as fp:
            w = Writer(fp)
            w.u64(self.ef_construction)
            w.u64(self.ef_search)
            w.u64(self.num_neighbours)
            w.u64(len(self.layers))
            for layer in self.layers:
                w.u64(len(layer.adjacency))
                for nid, item in layer.adjacency.items():
                    w.u64(nid)
                    pairs = item.items_sorted_ascending()
                    w.u64(len(pairs))
                    for p in pairs:
                        w.u64(p.candidate_id)
                        w.f32(p.distance)
                    w.vec_u64(
                        np.asarray(sorted(item.neighbours), dtype=np.uint64)
                    )
            w.f32(self.layer_multiplier)
            w.u64(len(self._id_row))
            for nid, row in self._id_row.items():
                w.u64(nid)
                w.f32_array(self._vecs[row])

    @classmethod
    def load_index(
        cls,
        file_path: str,
        dim: Optional[int] = None,
        config: Optional[HNSWConfig] = None,
        device=None,
    ) -> "HNSWIndex":
        """Load an index file (ours, the JAX package's or the Rust
        reference's): by the native one-pass scanner
        (``native.hnsw_scan``) where the native library is available,
        else by the Python bincode reader (``_load_index_python``); both
        give the same index."""
        if dim is None:
            # the file doesn't store dim (parity with the reference's
            # const-generic N, `base.rs:45-58`); the layers are d-free,
            # so it solves from the trailing id->vec block
            from vers_tpu_torch.io.infer import infer_dim_hnsw

            dim = infer_dim_hnsw(file_path)
        from vers_tpu_torch import native

        scan = native.hnsw_scan(file_path, dim)
        if scan is not None:
            return cls._from_native_scan(scan, dim, config, device)
        return cls._load_index_python(file_path, dim, config, device)

    @classmethod
    def _load_index_python(cls, file_path: str, dim: int,
                           config: Optional[HNSWConfig] = None,
                           device=None) -> "HNSWIndex":
        """``load_index``'s Python bincode reader (the behavioural
        reference of the native scanner)."""
        with open(file_path, "rb") as fp:
            r = Reader(fp)
            ef_construction = r.u64()
            ef_search = r.u64()
            num_neighbours = r.u64()
            num_layers = r.u64()
            layers = []
            for _ in range(num_layers):
                layer = _Layer()
                count = r.u64()
                for _ in range(count):
                    nid = r.u64()
                    heap_len = r.u64()
                    item = AdjacencyItem()
                    heap_pairs = [(r.u64(), r.f32()) for _ in range(heap_len)]
                    nbrs = r.vec_u64().astype(np.int64)
                    for cid, dist in heap_pairs:
                        item.insert(int(cid), float(dist))
                    # neighbour set is authoritative (heap may hold dups)
                    item.neighbours = set(int(x) for x in nbrs)
                    layer.adjacency[int(nid)] = item
                layers.append(layer)
            layer_multiplier = r.f32()
            n_vecs = r.u64()
            id_vec_pairs = []
            for _ in range(n_vecs):
                nid = r.u64()
                id_vec_pairs.append((int(nid), r.f32_array(dim)))
        index = cls(ef_construction, ef_search, num_layers, num_neighbours,
                    config=config, device=device)
        index.layers = layers
        index.layer_multiplier = layer_multiplier
        index.dim = dim
        for nid, vec in id_vec_pairs:
            index._set_vec(nid, vec)
        return index

    @classmethod
    def _from_native_scan(cls, scan: dict, dim: int,
                          config: Optional[HNSWConfig],
                          device=None) -> "HNSWIndex":
        """An index from the flat arrays of the native one-pass scanner
        (``native.hnsw_scan``): the same index as the Python reader of
        ``load_index`` gives."""
        layers: List[_Layer] = []
        node_pos = heap_pos = nbr_pos = 0
        node_ids, heap_lens = scan["node_ids"], scan["heap_lens"]
        nbr_lens, heap_ids = scan["nbr_lens"], scan["heap_ids"]
        heap_dists, nbrs = scan["heap_dists"], scan["nbrs"]
        for count in scan["layer_counts"]:
            layer = _Layer()
            for _ in range(int(count)):
                hlen = int(heap_lens[node_pos])
                nlen = int(nbr_lens[node_pos])
                item = AdjacencyItem()
                for h in range(heap_pos, heap_pos + hlen):
                    item.insert(int(heap_ids[h]), float(heap_dists[h]))
                # neighbour set is authoritative (heap may hold dups)
                item.neighbours = set(
                    int(x) for x in nbrs[nbr_pos : nbr_pos + nlen])
                layer.adjacency[int(node_ids[node_pos])] = item
                node_pos += 1
                heap_pos += hlen
                nbr_pos += nlen
            layers.append(layer)
        index = cls(int(scan["ef_construction"]), int(scan["ef_search"]),
                    int(scan["num_layers"]), int(scan["num_neighbours"]),
                    config=config, device=device)
        index.layers = layers
        index.layer_multiplier = float(scan["layer_multiplier"])
        index.dim = dim
        # the vector table in bulk (no per-row _set_vec calls)
        vecs = np.ascontiguousarray(scan["vecs"], dtype=np.float32)
        index._vecs = vecs if vecs.size else np.zeros((16, dim), np.float32)
        index._id_row = {int(nid): i for i, nid in enumerate(scan["vec_ids"])}
        index._rows_used = int(scan["vec_ids"].shape[0])
        return index
