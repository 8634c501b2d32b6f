"""The benchmark's corpus and queries, made on the device from the seed.

A frozen device copy of ``synthetic_gaussian`` in
``vers_tpu_torch/utils/data.py:170-190`` (the recipe that ``bench.py:103-106``
runs with ``n_clusters=1024, normalized=True, query_noise=0.5``): cluster
centres N(0, 4), each row a uniformly drawn centre plus N(0, 1) noise,
each query a uniformly drawn corpus row plus ``query_noise`` N(0, 1)
noise, rows and queries L2-normalised when asked (rows under 1e-6 left as
they are, the guard of ``vers_tpu_torch/core.py:121-126``). The host
version takes seconds at 1M x 300; this one draws with ``torch.Generator``
objects on the device in a few large calls, so the same seeds give the
same inputs on the same device. The corpus and the queries take a
generator each: a deployment's corpus is fixed (its configuration's
``corpus_seed``), its traffic is drawn from the run's seed. Imports torch
only.
"""

from __future__ import annotations

import torch

NORMALIZE_EPS = 1e-6


def normalize(x: torch.Tensor) -> torch.Tensor:
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(mag < NORMALIZE_EPS, x, x / mag.clamp_min(NORMALIZE_EPS))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` from any whole ``seed`` (negative or past
    64 bits folded into 63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def gaussian_clusters(corpus_gen: torch.Generator, query_gen: torch.Generator,
                      n: int, d: int, n_clusters: int, n_queries: int,
                      normalized: bool, query_noise: float):
    """(corpus (n, d) f32, queries (n_queries, d) f32) on the generators'
    device: the corpus from ``corpus_gen``, the queries (which rows they
    lie near, and their noise) from ``query_gen``."""
    dev = corpus_gen.device
    centres = torch.randn((n_clusters, d), generator=corpus_gen, device=dev) * 2.0
    assign = torch.randint(0, n_clusters, (n,), generator=corpus_gen, device=dev)
    data = torch.randn((n, d), generator=corpus_gen, device=dev)
    data += centres[assign]
    del assign, centres
    near = torch.randint(0, n, (n_queries,), generator=query_gen, device=dev)
    queries = data[near] + query_noise * torch.randn(
        (n_queries, d), generator=query_gen, device=dev)
    if normalized:
        data = normalize(data)
        queries = normalize(queries)
    return data.contiguous(), queries.contiguous()
