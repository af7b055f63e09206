"""k-means and exact kNN on the device — port of
``cet_pick_tpu/ops/kmeans.py``.

Replaces the reference's FAISS k-means (cet_pick/plot_2d.py:70-72,
models/kmeans.py:7-31) and its flat kNN index (utils/memory_bank.py:44-49),
as the JAX package does, with plain products: the JAX module has no Pallas
kernel, and its matmuls stay ``torch.matmul`` here (the kNN's in f32, with
TF32 off as the commands set it; Lloyd's in float64).

* ``kmeans_plus_plus``: k-means++ seeding (kmeans.py:36-52), each next
  centroid drawn in proportion to the squared distance to the nearest one
  chosen, by the Gumbel-max rule that ``jax.random.categorical`` uses; the
  draws come from a ``torch.Generator`` seeded with ``seed``, so their bits
  differ from JAX's ``PRNGKey(seed)`` while the distribution is the same.
* ``lloyd``: the Lloyd iterations from given centroids, in JAX's formulas
  (kmeans.py:54-74) carried in float64: distances expanded as
  x² − 2x·c + c², the first index winning a tie, the centroid sums as the
  one-hot product (a fixed-order reduction: no atomics, so a run repeats
  itself bit for bit), an empty cluster keeping its centroid, the inertia
  from the final assignment. The loop never leaves the device.
* ``knn_search``: blocked exact kNN (kmeans.py:84-121), ``block`` query rows
  at a time so that peak memory is O(block·N); ``exclude_self`` masks by
  index. Neighbours come in the order of (distance, index), as
  ``lax.top_k`` gives them: the lower index first among equal distances.
"""

from __future__ import annotations

import numpy as np
import torch


def _sq_dists(x, x_sq, cents):
    """(N, K) squared distances, as kmeans.py:55-58 forms them."""
    c_sq = torch.sum(cents * cents, dim=1)
    return x_sq - 2 * (x @ cents.T) + c_sq[None, :]


def kmeans_plus_plus(x, k, generator):
    """(k, D) initial centroids, rows of ``x`` (kmeans.py:36-52)."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator,
                          device=x.device)
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first[0]]
    mind2 = torch.sum((x - x[first]) ** 2, dim=1)
    for i in range(1, k):
        # categorical over log(max(mind2, 1e-12)) by Gumbel-max
        u = torch.rand(n, generator=generator, device=x.device,
                       dtype=x.dtype)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
        idx = torch.argmax(torch.log(mind2.clamp_min(1e-12)) + gumbel)
        c = x[idx]
        cents[i] = c
        mind2 = torch.minimum(mind2, torch.sum((x - c[None]) ** 2, dim=1))
    return cents


def lloyd(x, init, iters):
    """``iters`` Lloyd iterations from ``init`` (K, D) on x (N, D).
    Returns (centroids, assignment (N,), inertia) on x's device, the
    centroids and the inertia in x's dtype.

    The iterations run in float64. In float32 the card's products and the
    CPU's round differently, an assignment that is nearly a tie flips, and
    the flipped point moves its centroids for every later iteration: on
    25,750 embeddings (K 256, 300 iterations) the two ended 98.1% in
    agreement with centroids 6.1e-2 of the largest apart. In float64 the
    same run agrees between devices (PERF.md, PR 9)."""
    k = init.shape[0]
    xd = x.to(torch.float64)
    x_sq = torch.sum(xd * xd, dim=1, keepdim=True)
    cents = init.to(torch.float64)
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(xd, x_sq, cents), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(xd.dtype)
        counts = one_hot.sum(dim=0)
        sums = one_hot.T @ xd
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp_min(1)[:, None], cents)
    d2 = _sq_dists(xd, x_sq, cents)
    assign = torch.argmin(d2, dim=1)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    return cents.to(x.dtype), assign, inertia.to(x.dtype)


def kmeans_fit(x, k=256, iters=300, seed=1234):
    """k-means++ seeding from ``seed`` + ``lloyd`` (``kmeans_fit``,
    kmeans.py:25-74). x (N, D) float32 on any device."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    return lloyd(x, kmeans_plus_plus(x, k, gen), iters)


def kmeans(x, k=256, iters=300, seed=1234, device="cuda"):
    """numpy in, numpy out (kmeans.py:76-81): (centroids, assignment,
    inertia) after one fetch."""
    xt = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    cents, assign, inertia = kmeans_fit(xt, k=k, iters=iters, seed=seed)
    return cents.cpu().numpy(), assign.cpu().numpy(), float(inertia)


def _order_keys(d2, idx):
    """int64 keys that sort as (d2, idx) does: the float's bits made
    monotone (negative floats reversed), then the index in the low word.
    -0.0 counts as +0.0, as a float comparison has it."""
    bits = (d2 + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int64) << 32) | idx


def knn_search(queries, base, k=20, block=1024, exclude_self=False):
    """Exact kNN by blocked products: (distances (Q, k), indices (Q, k)) of
    the squared distances, nearest first, the lower index first among equal
    distances (kmeans.py:84-121). ``exclude_self`` sets query j's distance
    to base[j] to +inf (queries is base)."""
    q, n = queries.shape[0], base.shape[0]
    block = min(block, q)
    b_sq = torch.sum(base * base, dim=1)
    cols = torch.arange(n, device=base.device)
    dists, idxs = [], []
    for start in range(0, q, block):
        chunk = queries[start:start + block]
        c_sq = torch.sum(chunk * chunk, dim=1, keepdim=True)
        d2 = c_sq - 2 * (chunk @ base.T) + b_sq[None, :]
        if exclude_self:
            rows = start + torch.arange(len(chunk), device=base.device)
            d2 = torch.where(rows[:, None] == cols[None, :],
                             torch.tensor(float("inf"), device=d2.device), d2)
        keys = torch.topk(_order_keys(d2, cols[None, :]), k, dim=1,
                          largest=False, sorted=True).values
        idx = keys & 0xFFFFFFFF
        idxs.append(idx)
        dists.append(torch.gather(d2, 1, idx))
    return torch.cat(dists), torch.cat(idxs)
