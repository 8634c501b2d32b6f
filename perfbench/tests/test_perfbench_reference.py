"""The plain reference against NumPy brute force, and the judge on
answers it knows to be right or wrong, at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from perfbench.reference import data, ivf


def _problem(seed=5, n=1500, d=16, nlist=12, nq=40):
    gen = data.generator(seed, "cpu")
    x, q = data.gaussian_clusters(gen, data.generator(seed + 1, "cpu"), n, d, 8, nq,
                                  normalized=True, query_noise=0.5)
    ref = ivf.PlainIVF.build(x, nlist, 2, 10, seed=0, precision="f32")
    return x, q, ref


def _draw(corpus_seed, seed):
    return data.gaussian_clusters(data.generator(corpus_seed, "cpu"),
                                  data.generator(seed, "cpu"), 100, 8, 4, 10, True, 0.5)


def test_generator_is_seeded():
    a, b, c = _draw(0, 2 ** 31 + 5), _draw(0, 2 ** 31 + 5), _draw(0, 6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert not torch.equal(a[0], _draw(1, 6)[0])
    assert torch.allclose(a[0].norm(dim=1), torch.ones(100), atol=1e-5)


def test_tf32_round():
    v = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -2.5, 0.0])
    r = ivf.tf32_round(v)
    assert r.tolist() == [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -2.5, 0.0]


@pytest.mark.parametrize("nprobe", [1, 2, 0])
def test_plain_search_is_brute_force(nprobe):
    x, q, ref = _problem()
    xs, qs, c = x.numpy().astype(np.float64), q.numpy().astype(np.float64), ref.centroids.numpy()
    lists = ref.lists.numpy()
    assert np.array_equal(lists, ((xs[:, None] - c[None]) ** 2).sum(-1).argmin(1))
    d, i = ref.search(q, 5, nprobe)
    sizes = np.bincount(lists, minlength=len(c))
    for j in range(len(qs)):
        cd = ((c - qs[j]) ** 2).sum(1)
        order = np.argsort(cd, kind="stable")
        if nprobe:
            probed = order[:nprobe]
        else:
            probed, got = [], 0
            for o in order:
                if got >= 5:
                    break
                probed.append(o)
                got += min(sizes[o], 5)
        rows = np.nonzero(np.isin(lists, probed))[0]
        dist = ((xs[rows] - qs[j]) ** 2).sum(1)
        want = np.sort(dist)[:5]
        assert np.allclose(d[j].numpy(), want, atol=1e-5)
        assert np.allclose(((xs[i[j].numpy()] - qs[j]) ** 2).sum(1), want, atol=1e-5)


def test_judge_right_and_wrong_answers():
    x, q, ref = _problem()
    d, i = ref.search(q, 5, 2)
    good = ivf.judge(x, q, ref.centroids, ref.lists, d, i, 5, 2)
    assert good["stray_ids"] == 0 and good["assign_gap"] < 1e-6
    assert good["dist_err"] < 1e-6 and good["rank_gap"] < 1e-6
    assert 0.5 < good["recall_at_10"] <= 1.0
    bad_d = d.clone()
    bad_d[3, 0] += 0.01
    assert ivf.judge(x, q, ref.centroids, ref.lists, bad_d, i, 5, 2)["dist_err"] > 1e-3
    bad_i = i.clone()
    bad_i[4] = bad_i[4].roll(1)            # right rows, wrong order
    assert ivf.judge(x, q, ref.centroids, ref.lists, d, bad_i, 5, 2)["rank_gap"] > 1e-4
    bad_i = i.clone()
    bad_i[5, 1] = bad_i[5, 0]              # a repeat
    assert ivf.judge(x, q, ref.centroids, ref.lists, d, bad_i, 5, 2)["stray_ids"] >= 1
    moved = ref.lists.clone()
    far = ((x[0] - ref.centroids) ** 2).sum(1).argmax()
    moved[0] = far                         # a row in the wrong list
    assert ivf.judge(x, q, ref.centroids, moved, d, i, 5, 2)["assign_gap"] > 1e-3


def test_judge_allows_either_order_of_a_tie():
    x, q, ref = _problem()
    cent = ref.centroids.clone()
    q1 = q[:1]
    cd = ((cent - q1) ** 2).sum(1)
    second, third = cd.argsort()[1:3].tolist()
    cent[third] = cent[second]             # an exact tie at the probe's edge
    lists = ivf.assign(x, cent, "f64")
    plain = ivf.PlainIVF(x, cent, lists, "f32")
    d, i = plain.search(q1, 5, 2)
    res = ivf.judge(x, q1, cent, lists, d, i, 5, 2, truth=False)
    assert res["stray_ids"] == 0 and res["rank_gap"] < 1e-6


def test_control_reads_lower_precision():
    x, q, ref = _problem(n=3000, d=64)
    control = ivf.PlainIVF(x, ref.centroids, ref.lists, "tf32")
    d, i = control.search(q, 5, 2)
    res = ivf.judge(x, q, ref.centroids, ref.lists, d, i, 5, 2)
    assert res["dist_err"] > 1e-5
