"""Time the probe re-rank kernel, one IVF device query, the cluster-major
form of the IVF re-ranks and the LSH re-rank kernel of ONE checkout, for
comparing two checkouts on one card.

Run it from the root of each checkout in turn, within one job on one
card (parent, change, change, parent), and read the lines side by side:

    python zebra_tpu_torch/tools/ab_kernels.py LABEL [--ivf-only]

The checkout timed is the current directory's (its ``chip_smoke.py`` and
``zebra_tpu_torch``), so one copy of this file can time a checkout that
predates it: ``cd ../parent && python ../change/zebra_tpu_torch/tools/ab_kernels.py
parent``. It uses the checkout's own ``chip_smoke.py`` for the synthetic IVF
state (the main path's sizing: K=16384, C=128, D=768, int8 + residual, 45%
live; where the checkout has the cluster-major form, that form pinned by
``chip_smoke.in_form`` on the same state: int8 + residual at P=2, plain int8
and bf16 at P=4, k=10, and the wave re-rank on int8 at P=4, k=40) and for
the synthetic LSH candidates (a 2M x 768 slab, B=16384, M=3000 and 65,536:
the gather form; and, where the checkout has it, the sorted dense case of
B=1024 queries each holding ~20% of 1M occupied rows: the slab-major form
beside the gather form on the same arguments).
Probe selection is timed alone on random centroids of the same sizing (P=2).
Times are CUDA-event means; the host-to-host figure is a host clock around
``search_arrays`` (host arrays in and out).
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main(label: str, ivf_only: bool = False) -> int:
    import torch

    import chip_smoke as cs
    from zebra_tpu_torch.index import ivf as V
    from zebra_tpu_torch.index.ivf_host import IVFIndex
    from zebra_tpu_torch.ops import ivf_rerank as R
    from zebra_tpu_torch.ops import lsh_rerank as LR

    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    B = 16384
    st = cs.synthetic_state(torch, V, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, st.dim), generator=g, device=dev)
    pt = cs.synthetic_probes(torch, dev, B, st.num_clusters, 3)
    ks = [cs.time_ms(torch, lambda: R.ivf_rerank(st, q, pt, 10, "cosine"), 50) for _ in range(3)]
    idx = IVFIndex(dim=st.dim, device=dev)
    idx.state = st
    qn = q.cpu().numpy()
    idx.search_arrays(qn, 10)  # warm
    hs = []
    for _ in range(5):
        t0 = time.perf_counter()
        idx.search_arrays(qn, 10)
        hs.append((time.perf_counter() - t0) * 1e3)
    dq = cs.time_ms(torch, lambda: idx._query_device(q, 10, exact=False), 10)
    # probe selection alone on random centroids (the synthetic state's are zero)
    pst = V.empty_state(torch.randn((st.num_clusters, st.dim), generator=g, device=dev), 1, 1,
                        dtype=torch.int8, refine=True)
    sel = [cs.time_ms(torch, lambda: V.select_probes(pst, q, 2, "cosine"), 20) for _ in range(3)]
    print(f"{label}: ivf_rerank {' '.join(f'{k:.3f}' for k in ks)} ms; device query "
          f"{dq:.3f} ms; select_probes P=2 {' '.join(f'{m:.3f}' for m in sel)} ms; "
          f"search_arrays host-to-host {' '.join(f'{h:.1f}' for h in hs)} ms", flush=True)
    del idx, pst
    if hasattr(cs, "in_form"):
        from zebra_tpu_torch.ops import experimental_ivf as TX
        from zebra_tpu_torch.ops import ivf_cluster as IC

        p4 = cs.synthetic_probes(torch, dev, B, st.num_clusters, 3, P=4)
        out = [("int8+residual P=2", lambda: R.ivf_rerank(st, q, pt, 10, "cosine"))]
        for name, dtype in (("int8", torch.int8), ("bf16", torch.bfloat16)):
            s1 = cs.one_slab(torch, st, dtype)
            out.append((f"{name} P=4", lambda s1=s1: R.ivf_rerank(s1, q, p4, 10, "cosine")))
            if dtype == torch.int8:
                out.append(("wave int8 P=4 k=40",
                            lambda s1=s1: TX.ivf_rerank_wave(s1, q, p4, 40, "cosine")))
        line = []
        for name, call in out:
            ms = [cs.time_ms(torch, lambda: cs.in_form(IC, "cluster", call), 20)
                  for _ in range(3)]
            line.append(f"{name} " + "/".join(f"{m:.3f}" for m in ms))
        print(f"{label}: cluster-major form B={B}: " + "; ".join(line) + " ms", flush=True)
        del out, s1, p4
    del st, q, pt
    torch.cuda.empty_cache()
    if ivf_only:  # the LSH kernels' sources are not shared with the IVF ones
        return 0

    S, D = 2 * 1024 * 1024, 768
    g = torch.Generator(device=dev).manual_seed(4)
    slab = torch.randn((S, D), generator=g, device=dev)
    q = torch.randn((B, D), generator=g, device=dev)
    out = []
    for M in (3000, 65536):
        cand, valid = cs.lsh_candidates(torch, dev, S, B, M, M)
        norms = (slab ** 2).sum(-1)[torch.clamp(cand, 0, S - 1).long()]
        for vec in (slab, slab.to(torch.bfloat16)):
            ms = [cs.time_ms(torch, lambda: LR.lsh_rerank(vec, q, cand, norms, valid, k=10), 5)
                  for _ in range(2)]
            out.append(f"M={M} {str(vec.dtype)[6:]} " + "/".join(f"{m:.3f}" for m in ms))
        del cand, valid, norms
    print(f"{label}: lsh_rerank " + "; ".join(out) + " ms", flush=True)
    if hasattr(cs, "lsh_dense_candidates"):
        cand, norms, valid = cs.lsh_dense_candidates(torch, dev, slab, 1024, cs.DENSE_OCCUPIED,
                                                     cs.DENSE_SHARE, 9)
        args = (slab, q[:1024], cand, norms, valid)
        kw = dict(sorted_slots=True, occupied=cs.DENSE_OCCUPIED)
        ms = [cs.time_ms(torch, lambda: LR.lsh_rerank(*args, k=k, **form), 3)
              for k in (10, 128) for form in ({}, kw, kw, {})]
        print(f"{label}: lsh_rerank sorted dense B=1024 M={cand.shape[1]} f32, gather/slab/slab/"
              f"gather: k=10 " + "/".join(f"{m:.3f}" for m in ms[:4]) + "; k=128 "
              + "/".join(f"{m:.3f}" for m in ms[4:]) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--ivf-only"]
    sys.exit(main(args[0] if args else "tree", "--ivf-only" in sys.argv[1:]))
