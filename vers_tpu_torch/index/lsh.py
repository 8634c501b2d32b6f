"""RP-forest index ("LSH" in the reference) — counterpart of
``vers_tpu.index.lsh``; the reference is `vers/src/indexes/lsh.rs`.

Build: level-synchronous batched hyperplane splitting on the index's
device (``vers_tpu_torch.ops.rpforest``) instead of host recursion +
rayon (`lsh.rs:132-161`). Exact-duplicate vectors are dropped first
(parity with `deduplicate`, `lsh.rs:113-130`).

Search (batched): every tree routes the query batch to leaf buckets in
one batched descent, then each tree's buckets are scanned over a
gathered view of the ONE shared corpus with the packed-scan engine
(``vers_tpu_torch.ops.forest_shared``: kernel B on a CUDA index, its
plain version on a CPU index) and merged with id dedup — replacing the
rayon per-tree recursion + DashSet candidate union (`lsh.rs:264-281`).

Search (single query): host-side walk with exact behavioral parity with
`tree_result` (`lsh.rs:163-216`) including the deficit/backup branch
rule.

Documented deviations from the reference:
- tree depth is bounded (`ops/rpforest.depth_bound`); pathologically
  unbalanced nodes freeze into oversized leaves instead of recursing
  forever,
- ``add`` overflow splits just the overflowing leaf into a subtree,
  same as the reference (`lsh.rs:236-246`), with a seeded PRNG for the
  sampled hyperplanes and a bounded-attempt freeze for non-separating
  nodes; only if the descent falls off the recorded tables (defensive,
  loaded/degenerate trees) is the whole tree lazily rebuilt,
- ``add`` stores the new vector's *internal* index in tree leaves; the
  reference stores the external id (`lsh.rs:255-262`), which is only
  correct when no duplicates were removed — observable behavior is
  identical in that case and ours is also correct otherwise.

With no ``device`` an index lives on the first CUDA card
(``core.resolve_device``); ``device="cpu"`` runs the plain versions.

``forest_view()`` gives read-only views of the trees the batched search
serves from (hyperplanes, node tables, leaf membership, leaf sizes) and
the external id of each row, without copying them.

With ``trace`` on: spans ``lsh.search`` (a batched search call),
``lsh.layout`` (the shared-corpus device state built), ``lsh.build``
with ``lsh.dedup``, ``lsh.trees`` and ``lsh.tables`` inside it, and the
counters ``forest_leaves`` and ``forest_levels`` (each build's leaves
and the levels holding its trees' nodes, known on the host).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vers_tpu_torch import graphs, trace
from vers_tpu_torch.config import LSHConfig
from vers_tpu_torch.core import (
    as_query_matrix,
    deduplicate,
    device_id_map,
    resolve_device,
    round_up,
)
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.ops import rpforest
from vers_tpu_torch.ops.binned import adaptive_probe_depth, group_rows
from vers_tpu_torch.ops.cuda_binned import scans_on_host
from vers_tpu_torch.ops.forest_shared import (
    forest_search_shared,
    shared_tree_tables,
)

# Query rows per block of the packed scan's work items: kernel B's own
# query tile, so a block is one 64-row part and a search's plan units
# equal its work items.
Q_BLK = 64


class _Tree:
    """Host mirror of one tree: level tables + leaf membership."""

    def __init__(self, coeff, const, split, bucket, leaf_of_vec, num_buckets,
                 members=None):
        # np.array (not asarray): leaf splits mutate the tables in place
        self.coeff = np.array(coeff, np.float32)    # (L, T, d)
        self.const = np.array(const, np.float32)    # (L, T)
        self.split = np.array(split, np.int32)      # (L, S)
        self.bucket = np.array(bucket, np.int32)    # (L, S)
        self.leaf_of_vec = np.array(leaf_of_vec, np.int32)  # (n,)
        self.num_buckets = int(num_buckets)
        if members is not None:
            self.members = [np.asarray(m, np.int64).tolist() for m in members]
            return
        # each leaf's rows in ascending order: one stable sort, then a
        # split at the leaf boundaries
        lov = self.leaf_of_vec
        order = np.argsort(lov, kind="stable")
        order = order[np.searchsorted(lov[order], 0):]  # drop rows of no leaf
        counts = np.bincount(lov[order], minlength=self.num_buckets)
        self.members: List[List[int]] = [
            m.tolist() for m in np.split(order, np.cumsum(counts)[:-1])
        ] if self.num_buckets else []


class TreeView(NamedTuple):
    """Read-only views of one tree as the batched search serves it. A
    node is (level, position); position 0 of level 0 is the root. A node
    with ``split[l, v] = s >= 0`` is inner: its hyperplane is
    ``coeff[l, s]``, ``const[l, s]``, and a vector x goes to position
    ``2 s + 1`` of level l + 1 where ``coeff[l, s] . x + const[l, s] >= 0``
    (above), else to ``2 s``. A node with ``bucket[l, v] = b >= 0`` is
    leaf b; a node with neither is empty."""

    coeff: np.ndarray        # (L, T, d) f32 hyperplane normals
    const: np.ndarray        # (L, T) f32 hyperplane constants
    split: np.ndarray        # (L, S) i32 node -> hyperplane slot, or -1
    bucket: np.ndarray       # (L, S) i32 node -> leaf, or -1
    leaf_of_vec: np.ndarray  # (n,) i32 the leaf of each row
    leaf_sizes: np.ndarray   # (leaves,) i64 rows in each leaf's member list


class ForestView(NamedTuple):
    """``ANNIndex.forest_view()``: the trees and each row's external id."""

    trees: Tuple[TreeView, ...]
    ids: np.ndarray          # (n,) i64 external id of each row


def _read_only(a: np.ndarray) -> np.ndarray:
    view = a.view()
    view.flags.writeable = False
    return view


def _from_tables(tables: rpforest.ForestTables, n: int) -> _Tree:
    return _Tree(
        tables.coeff.cpu().numpy(), tables.const.cpu().numpy(),
        tables.split.cpu().numpy(), tables.bucket.cpu().numpy(),
        tables.leaf_of_vec[:n].cpu().numpy(), int(tables.num_buckets),
    )


class ANNIndex(Index):
    def __init__(
        self,
        max_node_size: int,
        trees: List[_Tree],
        values: np.ndarray,
        ids: np.ndarray,
        config: LSHConfig = LSHConfig(),
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.max_node_size = int(max_node_size)
        self._trees = trees
        # rows live in a buffer that doubles when full, so that ``add``
        # does not copy the corpus every time
        self._buf = np.asarray(values, dtype=np.float32)
        self._n = self._buf.shape[0]
        self._ids = np.asarray(ids, dtype=np.int64)
        self.dim = self._buf.shape[1]
        self._dirty_trees: set = set()
        self._shared = None    # shared-corpus device state
        self._sizes = None     # leaf sizes per tree, until the trees change
        self._ids_dev = None
        self._graphs = graphs.GraphCache()
        # seconds of the last build_index, host and device apart
        self.build_seconds: dict = {}

    @property
    def _values(self) -> np.ndarray:
        """(n, d) live rows (a view of the growable buffer)."""
        return self._buf[: self._n]

    @classmethod
    def from_numpy(cls, max_node_size: int, trees, values, ids,
                   config: LSHConfig = LSHConfig(), device=None):
        """An index over another package's state: ``trees`` is a
        sequence of objects with the level tables as attributes
        (``coeff``, ``const``, ``split``, ``bucket``, ``leaf_of_vec``,
        ``num_buckets`` and ``members``, as ``vers_tpu``'s
        ``ANNIndex._trees`` hold them); everything is copied."""
        own = [
            _Tree(t.coeff, t.const, t.split, t.bucket, t.leaf_of_vec,
                  t.num_buckets, members=t.members)
            for t in trees
        ]
        return cls(max_node_size, own, np.array(values, np.float32),
                   np.array(ids), config=config, device=device)

    def _flat_descent_tables(self):
        """Packed hyperplane tables for `rpforest.descend_forest_flat`:
        (coeff_flat (total, d) f32, const_flat (total,) f32,
        cbase (T, L) i32, splits (T, L, SC) i32, buckets (T, L, SC)
        i32). Test slots are allocated contiguously per level (device
        build: cumsum slots, `ops/rpforest.build_tree`; host inserts:
        next-free `_alloc_inner`), so level l's live rows are
        0..max(split_l)+1. The dense (T, L, TC, d) layout would be ~95%
        padding at 1M rows."""
        T = len(self._trees)
        L = max(t.coeff.shape[0] for t in self._trees)
        SC = max(t.split.shape[1] for t in self._trees)
        splits = np.full((T, L, SC), -1, np.int32)
        buckets = np.full((T, L, SC), -1, np.int32)
        nt = np.zeros((T, L), np.int64)
        for i, t in enumerate(self._trees):
            l_t, sc_t = t.split.shape
            splits[i, :l_t, :sc_t] = t.split
            buckets[i, :l_t, :sc_t] = t.bucket
            nt[i, :l_t] = t.split.max(axis=1, initial=-1) + 1
        total = max(int(nt.sum()), 1)
        coeff_flat = np.zeros((total, self.dim), np.float32)
        const_flat = np.zeros((total,), np.float32)
        cbase = np.zeros((T, L), np.int32)
        pos = 0
        for i, t in enumerate(self._trees):
            for l in range(t.coeff.shape[0]):
                k = int(nt[i, l])
                cbase[i, l] = pos
                coeff_flat[pos : pos + k] = t.coeff[l, :k]
                const_flat[pos : pos + k] = t.const[l, :k]
                pos += k
            cbase[i, t.coeff.shape[0] :] = pos
        return coeff_flat, const_flat, cbase, splits, buckets

    def _leaf_sizes(self) -> List[np.ndarray]:
        """Per tree, the row count of each leaf. Kept until ``add`` or a
        rebuild changes the trees: a search plans its tiles and its probe
        depth from them, and 1M rows make ~140k leaves to count."""
        if self._sizes is None:
            self._sizes = [
                np.fromiter(map(len, t.members), np.int64, len(t.members))
                for t in self._trees
            ]
        return self._sizes

    def forest_view(self) -> ForestView:
        """Read-only views (no copies) of the trees the batched search
        serves from, after any pending rebuild of trees an ``add``
        overflowed, and the external id of each row. Valid until the
        next ``add``."""
        self._rebuild_dirty()
        trees = tuple(
            TreeView(*(_read_only(a) for a in (
                t.coeff, t.const, t.split, t.bucket, t.leaf_of_vec, sizes)))
            for t, sizes in zip(self._trees, self._leaf_sizes()))
        return ForestView(trees, _read_only(self._ids))

    def _max_bin(self) -> int:
        return max((int(s.max()) for s in self._leaf_sizes() if s.size),
                   default=1)

    def _ensure_shared(self, r_blk: int) -> dict:
        """Shared-corpus device state (`ops/forest_shared`): ONE corpus
        copy + per-tree INDEX tables — the reference's memory shape
        (`lsh.rs:44,53`: corpus once, trees hold ids). Single slot
        cached per r_blk; the corpus upload survives table rebuilds.
        The corpus is padded to a multiple of 128 rows past n, so its
        last row is zero: padding slots of a tree's view gather it."""
        if self._shared is not None and self._shared["r_blk"] == r_blk:
            return self._shared
        with trace.span("lsh.layout"):
            dev = self.device
            corpus_pad = xx = None
            if self._shared is not None:
                corpus_pad = self._shared["corpus_pad"]
                xx = self._shared["xx"]
            t = shared_tree_tables(
                [tr.leaf_of_vec for tr in self._trees],
                [tr.num_buckets for tr in self._trees],
                r_blk,
            )
            if corpus_pad is None:
                n, d = self._values.shape
                corpus_pad = torch.zeros((round_up(n + 1, 128), d),
                                         dtype=torch.float32, device=dev)
                corpus_pad[:n] = torch.from_numpy(self._values).to(dev)
                xx = torch.sum(corpus_pad * corpus_pad, dim=1)
            coeff_flat, const_flat, cbase, splits, buckets = (
                self._flat_descent_tables()
            )

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            self._shared = dict(
                r_blk=r_blk,
                corpus_pad=corpus_pad,
                xx=xx,
                coeffs=put(coeff_flat),
                consts=put(const_flat),
                cbase=put(cbase),
                splits=put(splits),
                buckets=put(buckets),
                offsets=put(t["offsets"]),
                sizes_dev=put(t["sizes"].astype(np.int32)),
                src=put(t["src"]),
                rbin=put(t["rbin"]),
                g_first=put(t["g_first"]),
                g_max=t["g_max"],
                g_total=t["g_total"],
                num_bins=t["num_bins"],
                max_bin=t["max_bin"],
            )
            return self._shared

    # -- build ---------------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_trees: int,
        max_size: int,
        vectors: np.ndarray,
        vector_ids,
        config: Optional[LSHConfig] = None,
        device=None,
    ) -> "ANNIndex":
        """Parity signature with `lsh.rs:132-161` (dedup first, then
        num_trees independent random trees). The trees are built on
        ``device`` (the first CUDA card when None), one
        ``torch.Generator`` seeded from ``config.seed`` drawing every
        tree's permutations in turn."""
        if max_size < 2:
            raise ValueError("max_node_size must be >= 2")
        config = config or LSHConfig(num_trees=num_trees, max_node_size=max_size)
        device = resolve_device(device)
        with trace.span("lsh.build"):
            t0 = time.perf_counter()
            with trace.span("lsh.dedup"):
                vectors = np.asarray(vectors, dtype=np.float32)
                dedup_vecs, dedup_ids = deduplicate(vectors,
                                                    np.asarray(vector_ids))
            n, d = dedup_vecs.shape
            dedup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with trace.span("lsh.trees"):
                data = torch.zeros((round_up(max(n, 1), 128), d),
                                   dtype=torch.float32, device=device)
                data[:n] = torch.from_numpy(dedup_vecs).to(device)
                max_depth = rpforest.depth_bound(n, max_size)
                gen = torch.Generator(device=device).manual_seed(config.seed)
                tables = [
                    rpforest.build_tree(gen, data, n, max_size, max_depth)
                    for _ in range(num_trees)
                ]
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            device_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with trace.span("lsh.tables"):
                trees = [_from_tables(tb, n) for tb in tables]
            idx = cls(max_size, trees, dedup_vecs, dedup_ids, config,
                      device=device)
            idx.build_seconds = dict(
                dedup_host=dedup_s, trees_device=device_s,
                tables_host=time.perf_counter() - t0)
            if trace.enabled():
                trace.count("forest_leaves",
                            sum(t.num_buckets for t in trees))
                trace.count("forest_levels", sum(
                    int(((t.split >= 0) | (t.bucket >= 0)).any(axis=1).sum())
                    for t in trees))
        return idx

    # -- Index API -------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Parity surface with `Index::add` (`lsh.rs:253-262`): append
        the vector, then insert into every tree; when a leaf overflows
        max_node_size, rebuild JUST that leaf into a subtree
        (`lsh.rs:236-246` -> `build_a_tree`). Every other bucket is
        untouched. The search graphs are dropped."""
        self._graphs.invalidate()
        emb = np.asarray(embedding, dtype=np.float32).reshape(1, -1)
        internal = self._n
        if internal >= self._buf.shape[0]:
            grown = np.empty((max(2 * internal, 8), self.dim), np.float32)
            grown[:internal] = self._buf[:internal]
            self._buf = grown
        self._buf[internal] = emb[0]
        self._n = internal + 1
        self._ids = np.append(self._ids, np.int64(vec_id))
        for t, tree in enumerate(self._trees):
            b, lvl, v, on_path = self._descend_host_pos(tree, emb[0])
            tree.leaf_of_vec = np.append(tree.leaf_of_vec, np.int32(b))
            tree.members[b].append(internal)
            if len(tree.members[b]) > self.max_node_size:
                if on_path:
                    self._split_leaf(tree, t, lvl, v, b)
                else:
                    # defensive: the descent fell off the recorded
                    # tables (loaded/degenerate tree) — lazy whole-tree
                    # rebuild restores the invariant
                    self._dirty_trees.add(t)
        self._shared = None  # values grew: corpus re-uploads too
        self._sizes = None

    def _descend_host_pos(self, tree: _Tree, q: np.ndarray):
        """Main-path descent returning (bucket, level, position,
        on_path). ``on_path`` is False when the descent hit an
        unrecorded node (then bucket 0 is the defensive answer and the
        position is meaningless)."""
        v = 0
        for lvl in range(tree.split.shape[0]):
            b = tree.bucket[lvl][v] if v < tree.bucket.shape[1] else -1
            if b >= 0:
                return int(b), lvl, int(v), True
            s = tree.split[lvl][v] if v < tree.split.shape[1] else -1
            if s < 0:
                return 0, lvl, int(v), False
            side = 1 if float(tree.coeff[lvl][s] @ q + tree.const[lvl][s]) >= 0 else 0
            v = 2 * int(s) + side
        return 0, tree.split.shape[0] - 1, 0, False

    # -- leaf split (`lsh.rs:236-246` insert overflow -> build_a_tree) --

    @staticmethod
    def _grow_level_tables(tree: _Tree, lvl: int, pos: int) -> None:
        """Ensure the level tables cover level ``lvl`` and position
        ``pos`` (grafted subtrees may deepen or widen a level)."""
        L, S = tree.split.shape
        if lvl >= L:
            grow = lvl - L + 1
            tree.split = np.pad(tree.split, ((0, grow), (0, 0)), constant_values=-1)
            tree.bucket = np.pad(tree.bucket, ((0, grow), (0, 0)), constant_values=-1)
            tree.coeff = np.pad(tree.coeff, ((0, grow), (0, 0), (0, 0)))
            tree.const = np.pad(tree.const, ((0, grow), (0, 0)))
        if pos >= tree.split.shape[1]:
            grow = pos - tree.split.shape[1] + 1
            tree.split = np.pad(tree.split, ((0, 0), (0, grow)), constant_values=-1)
            tree.bucket = np.pad(tree.bucket, ((0, 0), (0, grow)), constant_values=-1)

    def _place_leaf(self, tree: _Tree, lvl: int, v: int, mem, reuse) -> None:
        self._grow_level_tables(tree, lvl, v)
        if reuse:
            b = reuse.pop()
            tree.members[b] = list(mem)
        else:
            b = tree.num_buckets
            tree.num_buckets += 1
            tree.members.append(list(mem))
        tree.bucket[lvl][v] = b
        tree.split[lvl][v] = -1
        for m in mem:
            tree.leaf_of_vec[m] = b

    def _alloc_inner(self, tree: _Tree, lvl: int, v: int,
                     normal: np.ndarray, const: float) -> int:
        self._grow_level_tables(tree, lvl, v)
        s_new = int(tree.split[lvl].max()) + 1  # next free slot
        if s_new >= tree.coeff.shape[1]:
            grow = s_new - tree.coeff.shape[1] + 1
            tree.coeff = np.pad(tree.coeff, ((0, 0), (0, grow), (0, 0)))
            tree.const = np.pad(tree.const, ((0, 0), (0, grow)))
        tree.coeff[lvl][s_new] = normal
        tree.const[lvl][s_new] = const
        tree.split[lvl][v] = s_new
        tree.bucket[lvl][v] = -1
        # children live at (lvl+1, 2*s_new / 2*s_new+1)
        self._grow_level_tables(tree, lvl + 1, 2 * s_new + 1)
        return s_new

    def _split_leaf(self, tree: _Tree, t_idx: int, lvl0: int, v0: int,
                    b0: int) -> None:
        """Rebuild the overflowing leaf's members into a subtree rooted
        at its position — the reference's insert-overflow behavior
        (`lsh.rs:236-246`): hyperplane from two sampled members
        (normal = b - a, through the midpoint, `lsh.rs:58-95`), recurse
        until every leaf holds < max_node_size. Deviations kept from
        the build path: a seeded PRNG replaces thread_rng (numpy's, with
        the JAX package's seed tuple, so a split matches it draw for
        draw), and a non-separating node freezes into an oversized leaf
        after bounded attempts instead of recursing forever."""
        members0 = list(tree.members[b0])
        rng = np.random.default_rng(
            (self.config.seed, 0x5EAF, t_idx, len(self._values))
        )
        reuse = [b0]
        stack = [(members0, lvl0, v0)]
        while stack:
            mem, lvl, v = stack.pop()
            if len(mem) < self.max_node_size:
                self._place_leaf(tree, lvl, v, mem, reuse)
                continue
            marr = np.asarray(mem, dtype=np.int64)
            for _ in range(8):
                i, j = rng.choice(len(mem), size=2, replace=False)
                a_v = self._values[mem[i]]
                b_v = self._values[mem[j]]
                normal = b_v - a_v
                const = -float(normal @ ((a_v + b_v) / 2.0))
                above = self._values[marr] @ normal + const >= 0
                if 0 < int(above.sum()) < len(mem):
                    break
            else:  # could not separate: freeze as oversized leaf
                self._place_leaf(tree, lvl, v, mem, reuse)
                continue
            s_new = self._alloc_inner(tree, lvl, v, normal, const)
            below_m = [m for m, s in zip(mem, above) if not s]
            above_m = [m for m, s in zip(mem, above) if s]
            stack.append((below_m, lvl + 1, 2 * s_new))      # left = below
            stack.append((above_m, lvl + 1, 2 * s_new + 1))  # right = above

    def _rebuild_dirty(self) -> None:
        if not self._dirty_trees:
            return
        self._graphs.invalidate()
        n, d = self._values.shape
        dev = self.device
        data = torch.zeros((round_up(max(n, 1), 128), d), dtype=torch.float32,
                           device=dev)
        data[:n] = torch.from_numpy(self._values).to(dev)
        max_depth = rpforest.depth_bound(n, self.max_node_size)
        for t in sorted(self._dirty_trees):
            gen = torch.Generator(device=dev).manual_seed(
                (self.config.seed + 1) * 1_000_003 + 1000 + t)
            self._trees[t] = _from_tables(
                rpforest.build_tree(gen, data, n, self.max_node_size,
                                    max_depth), n)
        self._dirty_trees.clear()
        self._sizes = None
        if self._shared is not None:
            # trees changed, values did not: rebuild the index tables
            # on next search but keep the uploaded corpus
            self._shared["r_blk"] = -1

    def _ids_device(self):
        """Cached device copy of the internal->external id map (int32),
        or None when any external id exceeds int32 range."""
        cached = self._ids_dev
        if cached is None or cached[0] is not self._ids:
            self._ids_dev = (self._ids, device_id_map(self._ids, self.device))
            cached = self._ids_dev
        return cached[1]

    def search_batch_device(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ):
        """Device-resident variant of ``search_batch``: returns
        (dists (Q,k) f32, external ids (Q,k) int32) tensors on the
        index's device with no host transfer: on a card the search and
        its id map enqueue without waiting for it, as one CUDA graph
        (see ``_search_batch_internal``), so calls chain and the caller
        drains once.

        External ids must fit in int32; raises ValueError otherwise
        (use ``search_batch``, which maps ids on the host in int64)."""
        return self._search_batch_internal(queries, top_k, probes_per_tree,
                                           ids=True)

    def search_batch(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ) -> SearchResult:
        """Multiprobe descent through the whole forest + packed binned
        scan per tree + merge.

        ``probes_per_tree=None`` (default) emulates the reference's
        deficit/backup rule (`lsh.rs:203-214`) size-aware: the static
        probe count comes from the leaf-size histogram (enough
        min-margin sibling probes that min(leaf, top_k) sums can reach
        top_k), and each (query, tree) deactivates ranks once its own
        running candidate count reaches top_k. An explicit int probes a
        fixed number of min-margin siblings per tree."""
        dists, internal = self._search_batch_internal(
            queries, top_k, probes_per_tree
        )
        internal = internal.cpu().numpy()
        ext = np.where(
            internal >= 0,
            self._ids[np.clip(internal, 0, len(self._ids) - 1)],
            -1,
        )
        return SearchResult(ids=ext.astype(np.int64),
                            distances=dists.cpu().numpy())

    def _auto_probes(self, top_k: int) -> int:
        """Static probe depth for the deficit-rule emulation: the
        worst-case number of leaves (sizes capped at top_k, adversarial
        smallest-first order, same rule as the IVF walk bound) any
        query could need to reach top_k candidates in ONE tree; capped
        at 8 ranks (beyond that the min-margin probes stray far from
        the backup branches anyway)."""
        depth = 1
        for sizes in self._leaf_sizes():
            if not sizes.size:
                sizes = np.ones((1,), np.int64)
            depth = max(depth, adaptive_probe_depth(sizes, top_k))
        return min(depth, 8)

    def _shared_plan(self, top_k: int):
        """Shared-corpus device state + tile sizes. Returns (shared state
        dict, statics dict) for `ops.forest_shared.forest_search_shared`."""
        chunk = 1024
        r_blk = group_rows(self._max_bin(), top_k, chunk)
        return self._ensure_shared(r_blk), dict(q_blk=Q_BLK, r_blk=r_blk,
                                                chunk=chunk)

    def _search_batch_internal(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None,
        ids: bool = False,
    ):
        """Batched search on the SHARED-corpus device state
        (`ops/forest_shared`): multiprobe descent + per-tree packed scan
        (one tree's gathered view live at a time) + dedup merge. Memory
        parity with the reference (`lsh.rs:44,53`): the corpus lives on
        the device exactly once. Returns (dists, internal rows), or with
        ``ids`` (dists, external ids int32).

        On a card the whole search is one CUDA graph (``graphs``: a
        configuration's second call captures it), its view buffer in the
        graph's pool, and the id map another of the same configuration;
        the plain engine (``engine="xla"``) and top_k > 128 read their
        work items on the host and run eagerly."""
        with trace.span("lsh.search"):
            self._rebuild_dirty()
            qdev = as_query_matrix(queries, self.device)
            if probes_per_tree is None:
                n_probes = self._auto_probes(top_k)
                deficit_k = top_k if n_probes > 1 else 0
            else:
                n_probes = max(1, probes_per_tree)
                deficit_k = 0
            engine = self.config.engine
            if engine not in ("auto", "pallas", "xla"):
                raise ValueError(f"unknown engine {engine!r}")
            sh, plan = self._shared_plan(top_k)
            idmap = self._ids_device() if ids else None
            if ids and idmap is None:
                raise ValueError(
                    "external ids exceed int32 range; the device-resident "
                    "path cannot map them — use search_batch()"
                )
            plain = engine == "xla"

            def search(q):
                return forest_search_shared(
                    q, sh["coeffs"], sh["consts"], sh["cbase"], sh["splits"],
                    sh["buckets"], sh["offsets"], sh["sizes_dev"],
                    sh["corpus_pad"], sh["xx"], sh["src"], sh["rbin"],
                    sh["g_first"], n_probes=n_probes,
                    num_bins=sh["num_bins"], top_k=top_k,
                    deficit_k=deficit_k, plain=plain, **plan,
                )

            def map_ids(dists, internal):
                return dists, torch.where(
                    internal >= 0,
                    idmap[torch.clamp(internal, 0, idmap.shape[0] - 1).to(
                        torch.int64)],
                    -1,
                )

            site = (None if scans_on_host(top_k, plain) else
                    self._graphs.site(("forest", top_k, n_probes, deficit_k),
                                      qdev, sh))
            out = graphs.run(site, "search", search, qdev)
            return graphs.run(site, "ids", map_ids, *out) if ids else out

    # -- single-query parity path (deficit/backup rule) ------------------

    def _tree_result(
        self, tree: _Tree, q: np.ndarray, n: int, lvl: int, v: int, cand: set
    ) -> int:
        """Exact behavioral parity with `tree_result` (`lsh.rs:163-216`),
        expressed as an explicit-stack DFS (depth-proof; adds can deepen
        a tree arbitrarily). The recursive budget threading is
        equivalent to one global remaining counter because the DFS
        visits a main subtree completely before its sibling backup, and
        backup nodes are only expanded while the deficit persists."""
        remaining = n
        stack = [(lvl, v)]
        while stack:
            lvl, v = stack.pop()
            if remaining <= 0:
                break
            if lvl >= tree.split.shape[0]:
                continue
            b = tree.bucket[lvl][v] if v < tree.bucket.shape[1] else -1
            s = tree.split[lvl][v] if v < tree.split.shape[1] else -1
            if s < 0:
                members = tree.members[int(b)] if b >= 0 else []
                if len(members) < remaining:
                    cand.update(members)
                    remaining -= len(members)
                else:
                    m = np.asarray(members, dtype=np.int64)
                    d2 = np.sum((self._values[m] - q[None, :]) ** 2, axis=1)
                    o = np.argsort(d2, kind="stable")[:remaining]
                    cand.update(int(m[i]) for i in o)
                    remaining = 0
                continue
            above = float(tree.coeff[lvl][s] @ q + tree.const[lvl][s]) >= 0
            main = 2 * int(s) + (1 if above else 0)
            backup = 2 * int(s) + (0 if above else 1)
            stack.append((lvl + 1, backup))
            stack.append((lvl + 1, main))
        return n - remaining

    def search_approximate(self, query, top_k: int) -> List[Tuple[int, float]]:
        self._rebuild_dirty()
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        cand: set = set()
        for tree in self._trees:
            self._tree_result(tree, q, top_k, 0, 0, cand)
        if not cand:
            return []
        m = np.asarray(sorted(cand), dtype=np.int64)
        d2 = np.sum((self._values[m] - q[None, :]) ** 2, axis=1)
        o = np.argsort(d2, kind="stable")[:top_k]
        return [(int(self._ids[m[i]]), float(d2[i])) for i in o]

    # -- persistence (bincode parity: `lsh.rs:31-55` layout) -------------

    def _write_tree(self, w: Writer, tree: _Tree) -> None:
        """Pre-order bincode emit of one tree via an explicit stack —
        depth-proof (adds can deepen a tree past any recursion limit)."""
        stack = [(0, 0)]
        while stack:
            lvl, v = stack.pop()
            s = tree.split[lvl][v] if lvl < tree.split.shape[0] else -1
            b = tree.bucket[lvl][v] if lvl < tree.bucket.shape[0] else -1
            if s >= 0:
                w.u32(0)  # Node::Inner variant tag
                w.f32_array(tree.coeff[lvl][s])
                w.f32(float(tree.const[lvl][s]))
                # pre-order: left (below) before right (above)
                stack.append((lvl + 1, 2 * int(s) + 1))
                stack.append((lvl + 1, 2 * int(s)))
            else:
                w.u32(1)  # Node::Leaf
                members = tree.members[int(b)] if b >= 0 else []
                w.vec_u64(np.asarray(members, dtype=np.uint64))

    def save_index(self, file_path: str) -> None:
        self._rebuild_dirty()
        with open(file_path, "wb") as fp:
            w = Writer(fp)
            w.u64(self.max_node_size)
            w.u64(len(self._trees))
            for tree in self._trees:
                self._write_tree(w, tree)
            w.vec_f32_matrix(self._values)
            w.vec_u64(self._ids.astype(np.uint64))

    @classmethod
    def load_index(
        cls,
        file_path: str,
        dim: Optional[int] = None,
        config: LSHConfig = LSHConfig(),
        device=None,
    ) -> "ANNIndex":
        if dim is None:
            # the file doesn't store dim (parity with the reference's
            # const-generic N, `base.rs:45-58`); candidate-scan + full
            # structural validation recovers it
            from vers_tpu_torch.io.infer import infer_dim_lsh

            dim = infer_dim_lsh(file_path)
        with open(file_path, "rb") as fp:
            r = Reader(fp)
            max_node_size = r.u64()
            num_trees = r.u64()
            raw_trees = [_parse_node(r, dim) for _ in range(num_trees)]
            values = r.vec_f32_matrix(dim)
            ids = r.vec_u64().astype(np.int64)
        trees = [_raw_to_tables(raw, values.shape[0], dim) for raw in raw_trees]
        return cls(max_node_size, trees, values, ids, config, device=device)


def _parse_node(r: Reader, dim: int):
    """Pre-order bincode parse of one tree via an explicit hole stack
    (depth-proof). Inner nodes are ["inner", coeff, const, left, right]
    lists."""
    root = [None]
    stack = [(root, 0)]  # (container, slot) awaiting the next node
    while stack:
        holder, slot = stack.pop()
        tag = r.u32()
        if tag == 0:
            node = ["inner", r.f32_array(dim), r.f32(), None, None]
            holder[slot] = node
            # pre-order: fill left (slot 3) before right (slot 4)
            stack.append((node, 4))
            stack.append((node, 3))
        elif tag == 1:
            holder[slot] = ("leaf", r.vec_u64().astype(np.int64))
        else:
            raise ValueError(f"bad Node enum tag {tag}")
    return root[0]


def _raw_to_tables(raw, n: int, dim: int) -> _Tree:
    """Convert a parsed recursive tree into level tables (BFS,
    inner-node slot = per-level inner count; children at 2s / 2s+1)."""
    levels: List[List] = [[raw]]
    while True:
        # children are indexed 2s/2s+1 by the PARENT's inner slot
        parents = [x for x in levels[-1] if x is not None and x[0] == "inner"]
        if not parents:
            break
        nxt: List = []
        for p in parents:
            nxt.extend([p[3], p[4]])
        levels.append(nxt)

    L = len(levels)
    t_caps = [max(sum(1 for x in lv if x is not None and x[0] == "inner"), 1) for lv in levels]
    T = max(t_caps)
    S = max(len(lv) for lv in levels)
    coeff = np.zeros((L, T, dim), np.float32)
    const = np.zeros((L, T), np.float32)
    split = np.full((L, S), -1, np.int32)
    bucket = np.full((L, S), -1, np.int32)
    leaf_of_vec = np.full((n,), -1, np.int32)
    members: List[List[int]] = []
    for lvl, lv in enumerate(levels):
        slot = 0
        for v, node in enumerate(lv):
            if node is None:
                continue
            if node[0] == "inner":
                coeff[lvl][slot] = node[1]
                const[lvl][slot] = node[2]
                split[lvl][v] = slot
                slot += 1
            else:
                b = len(members)
                bucket[lvl][v] = b
                mem = np.asarray(node[1], np.int64)
                members.append(mem)
                leaf_of_vec[mem[(mem >= 0) & (mem < n)]] = b
    return _Tree(coeff, const, split, bucket, leaf_of_vec, len(members),
                 members=members)
