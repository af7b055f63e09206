"""k-means and kNN of the port (``cet_pick_tpu_torch/ops/kmeans.py``)
against the JAX package's ``cet_pick_tpu/ops/kmeans.py``.

Tolerances: kNN indices equal, the order of ties included, and distances
within 1e-5 of each row's largest; the Lloyd loop from JAX's k-means++
seeding (``kmeans_fit(..., iters=0)``) to JAX's 30 iterations: assignments
equal, centroids within 1e-5 (measured 3.8e-6), inertia within 1e-5
relative (measured 6.0e-6: JAX's f32 expanded distance x² − 2x·c + c²
cancels ~1e3 to ~16; the port carries the iterations in float64, so that
the card and the CPU agree, ops/kmeans.lloyd).

Ties: XLA's fused product rounds two equal base rows' distances to one query
differently (1.6022439 against 1.6022441 for a duplicated row), so JAX's own
order of duplicated real-valued rows follows its rounding. The tie test
uses integer-valued embeddings, whose distances are exact in f32 on both
sides: there ``lax.top_k`` puts the lower index first, and so must the
port.

The ``cuda`` tests hold the card against the CPU; they import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kmeans.py
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.ops import kmeans as T
from chip_smoke import knn_agreement

torch.set_num_threads(1)

DIST_REL = 1e-5
CENT_TOL = 1e-5
INERTIA_REL = 1e-5


def _jax():
    jax = pytest.importorskip("jax")
    from cet_pick_tpu.ops import kmeans as J

    return jax, J


def gaussian_mixture(rng, n_per=50, k=4, d=16):
    """tests/test_viz.py:17-23."""
    centers = rng.standard_normal((k, d)) * 10
    pts = np.concatenate([centers[i] + rng.standard_normal((n_per, d))
                          for i in range(k)]).astype(np.float32)
    return pts, np.repeat(np.arange(k), n_per)


def _knn_both(q, b, **kw):
    jax, J = _jax()
    dj, ij = J.knn_search(jax.numpy.asarray(q), jax.numpy.asarray(b), **kw)
    dt, it = T.knn_search(torch.from_numpy(q), torch.from_numpy(b), **kw)
    return (np.asarray(dj), np.asarray(ij)), (dt.numpy(), it.numpy())


def _assert_knn(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    scale = np.abs(want[0]).max(axis=1, keepdims=True)
    assert (np.abs(got[0] - want[0]) <= DIST_REL * scale).all()


@pytest.mark.parametrize("block", [1024, 16], ids=["dense", "blocked"])
def test_knn_matches_jax(rng, block):
    q = rng.standard_normal((37, 8)).astype(np.float32)
    b = rng.standard_normal((53, 8)).astype(np.float32)
    _assert_knn(*_knn_both(q, b, k=5, block=block))


def test_knn_exclude_self_matches_jax(rng):
    x = rng.standard_normal((45, 8)).astype(np.float32)
    want, got = _knn_both(x, x, k=6, block=16, exclude_self=True)
    _assert_knn(want, got)
    assert not np.any(got[1] == np.arange(45)[:, None])


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_tie_order_matches_jax(rng, exclude_self):
    """Duplicated rows and integer values: many exact ties, the lower index
    first among them."""
    x = rng.integers(-2, 3, (40, 6)).astype(np.float32)
    x[30:] = x[:10]
    want, got = _knn_both(x, x, k=8, block=16, exclude_self=exclude_self)
    _assert_knn(want, got)
    d = got[0]
    ties = (d[:, 1:] == d[:, :-1]).sum()
    assert ties > 40  # the test exercises ties
    same = d[:, 1:] == d[:, :-1]
    assert (got[1][:, 1:][same] > got[1][:, :-1][same]).all()


def test_lloyd_from_jax_init_matches_kmeans_fit(rng):
    jax, J = _jax()
    pts, true = gaussian_mixture(rng)
    key = jax.random.PRNGKey(0)
    init, _, _ = J.kmeans_fit(jax.numpy.asarray(pts), key, k=4, iters=0)
    cj, aj, inj = J.kmeans_fit(jax.numpy.asarray(pts), key, k=4, iters=30)
    ct, at, int_ = T.lloyd(torch.from_numpy(pts),
                           torch.from_numpy(np.array(init)), 30)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=CENT_TOL)
    assert abs(float(int_) - float(inj)) <= INERTIA_REL * abs(float(inj))
    for t in range(4):  # tests/test_viz.py:26-33
        assert len(set(at.numpy()[true == t].tolist())) == 1


def test_empty_cluster_keeps_its_centroid():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
    init = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    cents, assign, inertia = T.lloyd(x, init, 3)
    assert torch.equal(cents[2], init[2])
    assert assign.tolist() == [0, 0, 1, 1]
    np.testing.assert_allclose(cents[:2].numpy(), [[0.05, 0.0], [5.05, 5.0]],
                               rtol=0, atol=1e-6)
    assert abs(float(inertia) - 4 * 0.05 ** 2) < 1e-5


def test_seeding_draws_rows_and_repeats(rng):
    x = torch.from_numpy(rng.standard_normal((60, 5)).astype(np.float32))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return T.kmeans_plus_plus(x, 12, gen)

    a = draw(7)
    assert torch.equal(a, draw(7))
    assert not torch.equal(a, draw(8))
    # every centroid is a row of x, and k-means++ picks no row twice here
    rows = [int(torch.nonzero((x == c).all(dim=1))[0]) for c in a]
    assert len(set(rows)) == 12
    cents, assign, _ = T.kmeans(x.numpy(), k=12, iters=0, seed=7,
                                device="cpu")
    np.testing.assert_array_equal(cents, a.numpy())
    assert assign.shape == (60,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kmeans_matches_cpu(cuda_device):
    """Lloyd on the card from the CPU's k-means++ init, 300 iterations of
    K = 64 over 4,000 points of 8 clusters (so most clusters are split, and
    near-ties exist): chip_smoke.py's cluster bars, assignments agreeing on
    >= 99.9% of the points, centroids within 1e-4 of the largest, inertia
    within 1e-5 relative; a second card run bit-identical (no atomics in
    the centroid sums)."""
    rng = np.random.default_rng(0)
    pts, _ = gaussian_mixture(rng, n_per=500, k=8, d=32)
    x = torch.from_numpy(pts)
    init = T.kmeans_plus_plus(x, 64, torch.Generator().manual_seed(1))
    cpu = T.lloyd(x, init, 300)
    card = T.lloyd(x.to(cuda_device), init.to(cuda_device), 300)
    again = T.lloyd(x.to(cuda_device), init.to(cuda_device), 300)
    assert all(torch.equal(a, b) for a, b in zip(card, again))
    agree = float((card[1].cpu() == cpu[1]).double().mean())
    assert agree >= 0.999
    scale = float(cpu[0].abs().max())
    assert float((card[0].cpu() - cpu[0]).abs().max()) <= 1e-4 * scale
    assert abs(float(card[2]) - float(cpu[2])) <= 1e-5 * float(cpu[2])


@pytest.mark.cuda
def test_cuda_knn_matches_cpu(cuda_device):
    """kNN on the card against the CPU (2,500 x 64, k 20, exclude_self):
    the rows equal outside a 1e-5 tie band between the k-th and (k+1)-th
    distances (their order where no two of the k + 1 lie in the band); and
    the integer-valued tie case equal, distances and order."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2500, 64)).astype(np.float32))
    cpu = T.knn_search(x, x, k=21, block=512, exclude_self=True)
    card = T.knn_search(x.to(cuda_device), x.to(cuda_device), k=20,
                        block=512, exclude_self=True)
    sets, set_bad, ordered, order_bad = knn_agreement(
        (cpu[0].numpy(), cpu[1].numpy()), card[1].cpu().numpy(), 20)
    assert sets > 2400 and set_bad == 0
    assert ordered > 2000 and order_bad == 0
    xi = torch.from_numpy(rng.integers(-2, 3, (600, 6)).astype(np.float32))
    xi[500:] = xi[:100]
    cpu = T.knn_search(xi, xi, k=12, block=128)
    card = T.knn_search(xi.to(cuda_device), xi.to(cuda_device), k=12,
                        block=128)
    assert torch.equal(card[1].cpu(), cpu[1])
    assert torch.equal(card[0].cpu(), cpu[0])
