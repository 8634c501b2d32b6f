"""The port's inline-neighbourhood beam (``ops/beam_inline.py``) and the
index's auto navigation policy against ``vers_tpu`` on the CPU:

- ``project_rows`` within 1e-3 (bf16 output);
- ``build_inline_table`` bit-identical (a gather);
- ``pca_projection`` equal up to the sign of each column;
- ``beam_search_layer_inline`` and ``full_descent_scan_inline`` on a
  JAX host-built graph with the JAX basis carried over, projected and
  exact-refined: ids equal or, row by row, differing only where two
  nav distances of the ids in question lie within 1e-6; rescored
  distances within 1e-5;
- ``auto_nav_policy``, ``auto_inline_dp`` and ``resolve_beam_expand``
  equal to the reference's on a grid of sizes and configs."""

import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vers_tpu.config import HNSWConfig as JaxConfig
from vers_tpu.index import hnsw as jh
from vers_tpu.index.hnsw import HNSWIndex as JaxHNSW
from vers_tpu.ops import beam_inline as jbi
from vers_tpu_torch.config import HNSWConfig
from vers_tpu_torch.index import hnsw as th
from vers_tpu_torch.ops import beam_inline as tbi
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

TOL = 1e-5
GAP = 1e-6


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(17)
    x = _normed(rng, 600, 32)
    j = JaxHNSW.build_index(4, 40, 32, 8, x, seed=0)
    c = j._ensure_device_cache()
    vecs = np.asarray(c["vecs"])
    basis = np.asarray(jbi.pca_projection(jnp.asarray(vecs), 16))
    proj = np.asarray(jbi.project_rows(jnp.asarray(vecs), jnp.asarray(basis), 16))
    return dict(
        x=x, q=_normed(rng, 40, 32), vecs=vecs, basis=basis, proj=proj,
        adj0=np.asarray(c["adjs"][0]),
        l1_tab=np.asarray(c["l1_tab"].astype(jnp.float32)),
        l1_members=np.asarray(c["l1_members"]), n1=int(c["n1"]),
    )


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # a JAX bf16 array: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bf16(a):
    return _t(a).to(torch.bfloat16)


def test_pca_projection_up_to_sign(graph):
    g = graph
    got = tbi.pca_projection(_t(g["vecs"]), 16).numpy()
    sign = np.sign((got * g["basis"]).sum(axis=0))
    assert (sign != 0).all()
    assert np.allclose(got * sign, g["basis"], rtol=0.0, atol=1e-4)


def test_project_rows_matches(graph):
    g = graph
    got = tbi.project_rows(_t(g["vecs"]), _t(g["basis"]), 16)
    assert got.dtype == torch.bfloat16
    assert np.allclose(got.float().numpy(), g["proj"].astype(np.float32),
                       rtol=0.0, atol=1e-3)
    # zero rows stay zero
    assert (got[600:].float() == 0).all()


def test_build_inline_table_identical(graph):
    g = graph
    adj = g["adj0"].copy()
    adj[5, 3] = -1
    want = np.asarray(jbi.build_inline_table(jnp.asarray(g["proj"]),
                                             jnp.asarray(adj), 16, row_chunk=128))
    got = tbi.build_inline_table(_bf16(g["proj"]), _t(adj), 16, row_chunk=100)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    with pytest.raises(ValueError):
        tbi.build_inline_table(_bf16(g["proj"]), _t(adj), 16, max_bytes=1000)


def _nav_dist(g, ids, row):
    xn = _bf16(g["vecs"]).double().numpy()
    qn = _bf16(g["q"][row]).double().numpy()
    return 1.0 - xn[np.asarray(ids)] @ qn


def _assert_traced(g, got_i, want_i):
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    for r in range(got_i.shape[0]):
        a = {int(i) for i in got_i[r] if i >= 0}
        b = {int(i) for i in want_i[r] if i >= 0}
        if a != b:
            d = np.sort(_nav_dist(g, sorted(a | b), r))
            assert np.diff(d).min() < GAP, (r, sorted(a - b), sorted(b - a))


@pytest.mark.parametrize("refine", [0, 12])
def test_beam_search_layer_inline_matches(graph, refine):
    g = graph
    q_n = g["q"].shape[0]
    seeds = np.tile(np.arange(4, dtype=np.int32)[None], (q_n, 1))
    qp = jbi.project_rows(jnp.asarray(g["q"]), jnp.asarray(g["basis"]), 16)
    tab = jbi.build_inline_table(jnp.asarray(g["proj"]), jnp.asarray(g["adj0"]), 16)
    sd = np.asarray(1.0 - jnp.einsum("qsd,qd->qs", jnp.asarray(g["proj"])[seeds], qp,
                                     preferred_element_type=jnp.float32))
    qnav = jnp.asarray(g["q"]).astype(jnp.bfloat16)
    want_d, want_i = jbi.beam_search_layer_inline(
        qp, tab, jnp.asarray(g["adj0"]), jnp.asarray(seeds), jnp.asarray(sd),
        ef=16, max_steps=64, expand_per_step=4, refine_r=refine,
        queries_nav=qnav, vecs_nav=jnp.asarray(g["vecs"]).astype(jnp.bfloat16))
    got_d, got_i = tbi.beam_search_layer_inline(
        _t(np.asarray(qp)), _t(np.asarray(tab)), _t(g["adj0"]), _t(seeds), _t(sd),
        ef=16, max_steps=64, expand_per_step=4, refine_r=refine,
        queries_nav=_bf16(g["q"]), vecs_nav=_bf16(g["vecs"]))
    _assert_traced(g, got_i, want_i)
    same = (got_i.numpy() == np.asarray(want_i)).all(axis=1)
    assert same.mean() > 0.9
    assert np.allclose(got_d.numpy()[same], np.asarray(want_d)[same],
                       rtol=0.0, atol=TOL)


@pytest.mark.parametrize("refine,ef,seeds", [(0, 32, 8), (64, 32, 8), (20, 16, 2)])
def test_full_descent_scan_inline_matches(graph, refine, ef, seeds):
    g = graph
    tab = np.asarray(jbi.build_inline_table(jnp.asarray(g["proj"]),
                                            jnp.asarray(g["adj0"]), 16))
    jv = jnp.asarray(g["vecs"])
    want_d, want_i = jbi.full_descent_scan_inline(
        jnp.asarray(g["q"]), jv, jv.astype(jnp.bfloat16), jnp.asarray(g["basis"]),
        jnp.asarray(g["proj"]), jnp.asarray(tab), jnp.asarray(g["adj0"]),
        jnp.asarray(g["l1_tab"]).astype(jnp.bfloat16), jnp.asarray(g["l1_members"]),
        g["n1"], top_k=10, ef=ef, seeds=seeds, expand=4, steps_cap=8,
        refine_r=refine)
    tv = _t(g["vecs"])
    got_d, got_i = tbi.full_descent_scan_inline(
        _t(g["q"]), tv, tv.to(torch.bfloat16), _t(g["basis"]), _bf16(g["proj"]),
        _t(tab), _t(g["adj0"]), _t(g["l1_tab"]), _t(g["l1_members"]), g["n1"],
        top_k=10, ef=ef, seeds=seeds, expand=4, steps_cap=8, refine_r=refine)
    _assert_traced(g, got_i, want_i)
    same = (got_i.numpy() == np.asarray(want_i)).all(axis=1)
    assert np.allclose(got_d.numpy()[same], np.asarray(want_d)[same],
                       rtol=0.0, atol=TOL)
    assert same.mean() > 0.9


def _grid():
    sizes = [(1_000, 1_024), (199_999, 200_064), (200_000, 200_064),
             (1_000_000, 1_000_064), (3_000_000, 3_000_064),
             (5_000_000, 5_000_064)]
    cfgs = [dict(), dict(max_degree=16), dict(max_degree=48),
            dict(nav_inline_dp=None), dict(nav_inline_dp=0),
            dict(nav_inline_dp=32), dict(route_mode="beam"),
            dict(inline_hbm_budget_gb=2.0), dict(inline_hbm_budget_gb=0.1),
            dict(beam_expand=3), dict(beam_expand=0)]
    return list(itertools.product(sizes, cfgs))


@pytest.mark.parametrize("size,cfg", _grid())
def test_auto_policy_matches(size, cfg):
    n_rows, n_pad = size
    jc, tc = JaxConfig(**cfg), HNSWConfig(**cfg)
    assert th.auto_nav_policy(tc, n_rows, n_pad) == jh.auto_nav_policy(jc, n_rows, n_pad)
    for deg in (16, 32, 49):
        assert (th.auto_inline_dp(tc, n_rows, n_pad, deg)
                == jh.auto_inline_dp(jc, n_rows, n_pad, deg))
    for inline_on in (False, True):
        assert (th.resolve_beam_expand(tc, inline_on)
                == jh.resolve_beam_expand(jc, inline_on))


def test_policy_at_the_smoke_size():
    # 1M rows with the reference's (12, 100, 32, 24): cap 32, dp 64
    assert th.auto_nav_policy(HNSWConfig(num_neighbours=24), 1_000_000,
                              1_000_064) == (32, 64)
    assert th.INLINE_DEG_CAP == jh.INLINE_DEG_CAP


def test_config_fields_match():
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(HNSWConfig)}
    assert got == want


def test_inline_seeds_projected(graph):
    """refine_r = 0 seeds the beam in projected space: the inline search
    still returns exact f32 distances ascending."""
    g = graph
    tab = tbi.build_inline_table(_bf16(g["proj"]), _t(g["adj0"]), 16)
    tv = _t(g["vecs"])
    d, i = tbi.full_descent_scan_inline(
        _t(g["q"]), tv, tv.to(torch.bfloat16), _t(g["basis"]), _bf16(g["proj"]),
        tab, _t(g["adj0"]), _t(g["l1_tab"]), _t(g["l1_members"]), g["n1"],
        top_k=5, ef=16, seeds=4, expand=4, steps_cap=8, refine_r=0)
    exact = 1.0 - np.einsum("qkd,qd->qk", g["vecs"][i.numpy()], g["q"])
    assert np.allclose(d.numpy(), exact, rtol=0.0, atol=TOL)
    assert (np.diff(d.numpy(), axis=1) >= 0).all()
    assert_topk_match(d, i, d, i)
