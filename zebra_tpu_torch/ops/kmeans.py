"""k-means (Lloyd's) for IVF coarse quantisation (port of
``zebra_tpu/ops/kmeans.py``: ``assign_clusters``, ``kmeans`` and
``kmeans_paced``).

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


def _lloyd_pass(data: torch.Tensor, n_valid: int, cents: torch.Tensor, reseed_rows: torch.Tensor,
                chunk: int):
    """One Lloyd assignment + update pass over the ``n_valid`` leading rows
    (chunks cast to f32 one at a time); empty clusters restart at their
    reseed row."""
    k, dim = cents.shape
    dev = data.device
    cn2 = (cents * cents).sum(-1)
    sums = torch.zeros((k, dim), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.int32, device=dev)
    for s in range(0, n_valid, chunk):
        xc = data[s : min(s + chunk, n_valid)].float()
        a = torch.argmin(cn2[None, :] - 2.0 * (xc @ cents.T), dim=1)
        sums.index_add_(0, a, xc)
        counts.index_add_(0, a, torch.ones_like(a, dtype=torch.int32))
    mean = sums / torch.clamp(counts, min=1)[:, None]
    # empty clusters restart at a random data point (Lloyd repair)
    return torch.where((counts > 0)[:, None], mean, data[reseed_rows].float()), counts


def _balance_step(data, n_valid: int, cents, counts, split_rows, reseed_pair, chunk: int, m: int):
    """One split-heavy balance round: the ``m`` lightest centroids move next
    to the ``m`` heaviest (a perturbed copy), then two settling passes."""
    k = cents.shape[0]
    order = torch.argsort(-counts, stable=True)
    heavy, light = order[:m], order[k - m :]
    cents = cents.clone()
    cents[light] = 0.99 * cents[heavy] + 0.01 * data[split_rows].float()
    cents, counts = _lloyd_pass(data, n_valid, cents, reseed_pair[0], chunk)
    return _lloyd_pass(data, n_valid, cents, reseed_pair[1], chunk)


def _lloyd(data, n_valid, k, iters, chunk, balance_rounds, generator, init_idx, reseed_idx,
           split_idx, pacer):
    """The shared body of :func:`kmeans` and :func:`kmeans_paced`:
    ``pacer(counts)`` runs after each Lloyd pass and each balance round."""
    n = data.shape[0]
    dev = data.device
    n_valid = int(n_valid)
    if init_idx is None or reseed_idx is None or split_idx is None:
        init_idx, reseed_idx, split_idx = kmeans_draws(
            n, n_valid, k, iters, balance_rounds, generator, dev
        )
    init_idx, reseed_idx, split_idx = (
        torch.as_tensor(t, device=dev).long() for t in (init_idx, reseed_idx, split_idx)
    )
    cents = data[init_idx].float()
    counts = torch.zeros((k,), dtype=torch.int32, device=dev)
    for it in range(iters):
        cents, counts = _lloyd_pass(data, n_valid, cents, reseed_idx[it], chunk)
        pacer(counts)
    m = max(k // 8, 1)
    for r in range(balance_rounds):
        pair = reseed_idx[iters + 2 * r : iters + 2 * r + 2]
        cents, counts = _balance_step(data, n_valid, cents, counts, split_idx[r], pair, chunk, m)
        pacer(counts)
    return cents, counts


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
    return _lloyd(data, n_valid, k, iters, chunk, balance_rounds, generator, init_idx,
                  reseed_idx, split_idx, lambda counts: None)


def _pace(counts: torch.Tensor) -> None:
    """Wait for the device work queued so far on the current stream (a
    no-op for CPU tensors)."""
    if counts.is_cuda:
        torch.cuda.current_stream(counts.device).synchronize()


def kmeans_paced(
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
    pacer=None,
):
    """:func:`kmeans`, queued one pass at a time (``zebra_tpu/ops/kmeans.py:159``):
    after each Lloyd pass and each balance round ``pacer(counts)`` (default:
    wait for the current stream) drains what was queued, so a query queued
    on the same stream by another thread waits at most about one pass, not
    the whole training. The background retrain's shadow trains with it; the
    same draws give the same passes as :func:`kmeans`."""
    return _lloyd(data, n_valid, k, iters, chunk, balance_rounds, generator, init_idx,
                  reseed_idx, split_idx, pacer or _pace)
