"""Kernels A and B on the card against their plain versions, at small
edge shapes (ragged query tiles and corpus chunks, k = 1 and k = MAX_K,
cosine, gated probe ranks, exact ties).

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips without one. This file imports neither jax nor vers_tpu, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Distances are held to rtol 1e-4 / atol 1e-4 (f32 sums in other orders;
TF32 off); ids tie-aware.
"""

import numpy as np
import pytest
import torch

from vers_tpu_torch.ops import binned, cuda_binned, cuda_topk
from vers_tpu_torch.ops.topk import fused_scan_topk
from vers_tpu_torch.utils.parity import assert_topk_match

pytestmark = pytest.mark.gpu

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want):
    assert_topk_match(got[0], got[1], want[0], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("q_n,n,n_valid,d,k", [
    (100, 3000, 2999, 37, 10),
    (64, 512, 512, 16, 1),
    (130, 1000, 900, 300, cuda_topk.MAX_K),
    (7, 200, 5, 8, 9),  # k > n_valid: (+inf, -1) tail
])
def test_distance_topk_kernel_matches_plain(cuda, metric, q_n, n, n_valid, d, k):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        x = torch.nn.functional.normalize(x, dim=1)
        q = torch.nn.functional.normalize(q, dim=1)
    before = cuda_topk.LAUNCHES
    got = cuda_topk.cuda_distance_topk(q, x, n_valid, k, metric=metric)
    torch.cuda.synchronize()
    assert cuda_topk.LAUNCHES == before + 1
    _check(got, fused_scan_topk(q, x, n_valid, k, metric=metric, chunk_size=256))


def test_distance_topk_kernel_tie_order(cuda):
    """Duplicated corpus rows tie exactly; the lower row comes first."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(300, 20)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base, base])).to(cuda)
    q = torch.from_numpy(base[:50] + 0.01).to(cuda)
    d, i = cuda_topk.cuda_distance_topk(q, x, 900, 6)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    same = d[:, 1:] == d[:, :-1]
    assert same.any()
    assert (i[:, 1:][same] > i[:, :-1][same]).all()
    _check((d, i), fused_scan_topk(q, x, 900, 6))


def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((256, 8), device=cuda)
    with pytest.raises(TypeError):
        cuda_topk.cuda_distance_topk(x.double(), x.double(), 256, 4)
    with pytest.raises(ValueError):
        cuda_topk.cuda_distance_topk(x.cpu(), x, 256, 4)
    with pytest.raises(ValueError):
        cuda_topk.cuda_distance_topk(x, x, 256, cuda_topk.MAX_K + 1)


def _layout(n, d, k, skew, dev, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = ((rng.random(n) ** 3 * k).astype(np.int64) if skew
            else rng.integers(0, k, n))
    return binned.make_layout(x, bins, k, device=dev), rng


@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n,d,k,q_n,nprobe,skew,q_blk", [
    (3000, 32, 16, 200, 1, False, 64),
    (3000, 32, 16, 500, 3, True, 128),
    (997, 16, 7, 33, 2, True, 64),
    (5000, 300, 40, 700, 8, True, 128),
])
def test_binned_search_kernel_matches_plain(cuda, kernel_ids, metric, n, d, k,
                                            q_n, nprobe, skew, q_blk):
    layout, rng = _layout(n, d, k, skew, cuda)
    cents = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q, dim=1)
    kw = dict(top_k=10, metric=metric, q_blk=q_blk, r_blk=256, chunk=128,
              kernel_ids=kernel_ids)
    before = cuda_binned.LAUNCHES
    got = binned.binned_topk_kernel(q, cents, nprobe, layout, **kw)
    torch.cuda.synchronize()
    assert cuda_binned.LAUNCHES == before + 1
    _check(got, binned.binned_topk_kernel(q, cents, nprobe, layout, plain=True,
                                          **kw))


def test_binned_search_gated_ranks(cuda):
    """Sentinel (gated) probe ranks contribute nothing on the kernel."""
    layout, rng = _layout(3000, 32, 16, False, cuda)
    q = torch.from_numpy(rng.normal(size=(192, 32)).astype(np.float32)).to(cuda)
    near = torch.from_numpy(rng.integers(0, 16, (192, 1))).to(cuda)
    gated = torch.cat([near, torch.full_like(near, 16)], dim=1)
    mixed = gated.clone()
    mixed[1::2, 1] = (near[1::2, 0] + 3) % 16
    kw = dict(top_k=8, q_blk=64, r_blk=256, chunk=128)
    one = binned.binned_topk_kernel(q, None, 1, layout, probes=near, **kw)
    _check(binned.binned_topk_kernel(q, None, 2, layout, probes=gated, **kw), one)
    _check(binned.binned_topk_kernel(q, None, 2, layout, probes=mixed, **kw),
           binned.binned_topk_kernel(q, None, 2, layout, probes=mixed,
                                     plain=True, **kw))


def _clustered(seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, 24)).astype(np.float32) * 3
    x = centers[rng.integers(0, 20, 4000)] + rng.normal(size=(4000, 24)).astype(
        np.float32)
    q = x[:100] + 0.1 * rng.normal(size=(100, 24)).astype(np.float32)
    # unit rows, as the real workload: the |q|^2 + |x|^2 - 2 q.x form
    # loses ~eps * |x|^2 to cancellation, so unnormalized rows of norm
    # ~15 would need a looser tolerance than the kernel comparison's
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def test_ivf_index_on_cuda_matches_cpu(cuda):
    import vers_tpu_torch as vt

    x, q = _clustered()
    cpu = vt.IVFFlatIndex.build_index(32, 2, 10, x)
    gpu = vt.IVFFlatIndex.from_numpy(32, cpu._values, cpu._centroids,
                                     cpu._assignments, cpu._ids, device=cuda)
    for nprobe in (0, 1, 3):
        a = gpu.search_batch(q, 10, nprobe=nprobe)
        b = cpu.search_batch(q, 10, nprobe=nprobe)
        _check((a.distances, a.ids), (b.distances, b.ids))
    flat_g = vt.FlatIndex(x, device=cuda).search_batch(q, 10)
    flat_c = vt.FlatIndex(x).search_batch(q, 10)
    _check((flat_g.distances, flat_g.ids), (flat_c.distances, flat_c.ids))


def test_ivf_plain_engine_matches_auto(cuda):
    """engine='auto' launches kernel B; engine='xla' runs its plain
    version on the same card tensors; the two agree."""
    import vers_tpu_torch as vt

    x, q = _clustered()
    auto = vt.IVFFlatIndex.build_index(32, 2, 10, x, device=cuda)
    auto._materialize_host()
    plain = vt.IVFFlatIndex.from_numpy(
        32, auto._values, auto._centroids, auto._assignments, auto._ids,
        config=vt.IVFFlatConfig(num_clusters=32, engine="xla"), device=cuda)
    before = cuda_binned.LAUNCHES
    a = auto.search_batch(q, 10, nprobe=2)
    assert cuda_binned.LAUNCHES == before + 1
    b = plain.search_batch(q, 10, nprobe=2)
    assert cuda_binned.LAUNCHES == before + 1
    _check((a.distances, a.ids), (b.distances, b.ids))
