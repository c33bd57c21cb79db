"""k-means (Lloyd's) for IVF coarse quantisation (port of
``zebra_tpu/ops/kmeans.py``: ``assign_clusters`` and ``kmeans``).

JAX draws its three random index sets inside the jit from one key; here they
are explicit arguments (``init_idx``, ``reseed_idx``, ``split_idx``) so tests
can inject the JAX draws. When not given they come from a ``torch.Generator``.
``sums.at[a].add`` becomes ``index_add_``: on CUDA that uses atomics, so the
order of each centroid's sum — and its last bits — changes from run to run.
"""

from __future__ import annotations

import torch


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid (sql2) assignment ``[n]`` int64, chunked over rows."""
    cn2 = (centroids * centroids).sum(-1)
    out = []
    for s in range(0, x.shape[0], chunk):
        dot = x[s : s + chunk].float() @ centroids.T
        out.append(torch.argmin(cn2[None, :] - 2.0 * dot, dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=x.device)


def kmeans_draws(n: int, n_valid: int, k: int, iters: int, balance_rounds: int,
                 generator: torch.Generator | None = None, device="cpu"):
    """The three index draws of :func:`kmeans` (JAX: ``randint % n_valid``
    from three split keys): init ``[k]``, reseed ``[iters + 2*rounds, k]``
    and split ``[max(rounds, 1), k // 8]``."""
    nv = max(int(n_valid), 1)
    m = max(k // 8, 1)
    total = iters + 2 * balance_rounds

    def draw(shape):
        r = torch.randint(0, n, shape, generator=generator, device=device)
        return r % nv

    return draw((k,)), draw((total, k)), draw((max(balance_rounds, 1), m))


def kmeans(
    data: torch.Tensor,
    n_valid: int,
    k: int,
    iters: int = 8,
    chunk: int = 65536,
    balance_rounds: int = 2,
    generator: torch.Generator | None = None,
    init_idx: torch.Tensor | None = None,
    reseed_idx: torch.Tensor | None = None,
    split_idx: torch.Tensor | None = None,
):
    """Lloyd's k-means with split-heavy balance rounds.

    Each balance round moves the k/8 lightest centroids next to the k/8
    heaviest (a perturbed copy) and runs two more Lloyd iterations, which
    bounds the max cluster load (and so IVF spill and spare pressure).

    Args:
      data: ``[n, D]`` training rows (any float dtype); rows ``>= n_valid``
        are padding and never assigned.
      init_idx / reseed_idx / split_idx: the random row draws (see
        :func:`kmeans_draws`); drawn from ``generator`` when omitted.

    Returns ``(centroids [k, D] f32, counts [k] int32)`` — counts of the last
    assignment pass.
    """
    n, dim = data.shape
    dev = data.device
    n_valid = int(n_valid)
    if init_idx is None or reseed_idx is None or split_idx is None:
        init_idx, reseed_idx, split_idx = kmeans_draws(
            n, n_valid, k, iters, balance_rounds, generator, dev
        )
    init_idx, reseed_idx, split_idx = (
        torch.as_tensor(t, device=dev).long() for t in (init_idx, reseed_idx, split_idx)
    )
    live = data[:n_valid]

    def rows(idx):
        return data[idx].float()

    def lloyd(cents, reseed_rows):
        cn2 = (cents * cents).sum(-1)
        sums = torch.zeros((k, dim), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.int32, device=dev)
        for s in range(0, n_valid, chunk):
            xc = live[s : s + chunk].float()
            a = torch.argmin(cn2[None, :] - 2.0 * (xc @ cents.T), dim=1)
            sums.index_add_(0, a, xc)
            counts.index_add_(0, a, torch.ones_like(a, dtype=torch.int32))
        mean = sums / torch.clamp(counts, min=1)[:, None]
        # empty clusters restart at a random data point (Lloyd repair)
        return torch.where((counts > 0)[:, None], mean, rows(reseed_rows)), counts

    cents = rows(init_idx)
    counts = torch.zeros((k,), dtype=torch.int32, device=dev)
    for it in range(iters):
        cents, counts = lloyd(cents, reseed_idx[it])
    m = max(k // 8, 1)
    for r in range(balance_rounds):
        order = torch.argsort(-counts, stable=True)
        heavy, light = order[:m], order[k - m :]
        cents = cents.clone()
        cents[light] = 0.99 * cents[heavy] + 0.01 * rows(split_idx[r])
        cents, counts = lloyd(cents, reseed_idx[iters + 2 * r])
        cents, counts = lloyd(cents, reseed_idx[iters + 2 * r + 1])
    return cents, counts
