"""Time both kernel forms of the IVF probe re-ranks over batch sizes, to place
the route's crossover (``ops.ivf_cluster.MIN_PAIR_COLUMNS``).

Run from the repository root on a CUDA card:

    python zebra_tpu_torch/tools/ivf_crossover.py [--only LABEL ...]

The synthetic IVF state of ``chip_smoke.py`` (the main path's sizing:
K=16384, C=128, D=768, int8 + residual, ragged counts, tombstones), its
coarse values as a bf16 and as an f32 slab, and the augmented slab of each
(D + 128 = 896 lanes); uniform random probes; B = 256 ... 16384 and P = 2,
4; kernel 1 on int8 + residual, bf16 and f32 (k=10), kernel 2 on int8 and
f32 (k=40), kernel 3 on the bf16 aug slab (``exact`` on and off) and the
f32 one (k=10). Each line times the per-query form and the cluster-major
form (``chip_smoke.in_form`` pins one) in turns per-query, cluster,
cluster, per-query, as CUDA-event means over calls from the host, so the
cluster-major form's pair sort and items kernel count with their launch
overhead. The last lines name, per key of ``MIN_PAIR_COLUMNS``, the largest
pairs x padded columns at which the cluster-major form lost a case: the
route's threshold goes above it.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main(argv=None) -> int:
    import argparse

    import torch

    import chip_smoke as cs
    from zebra_tpu_torch.index import ivf as V
    from zebra_tpu_torch.ops import experimental_ivf as TX
    from zebra_tpu_torch.ops import ivf_cluster as IC
    from zebra_tpu_torch.ops import ivf_rerank as R

    ap = argparse.ArgumentParser(description="Time the two forms of the IVF re-ranks.")
    ap.add_argument("--only", nargs="*", default=[],
                    help="run only the cases whose label holds one of these strings")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("ivf_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((16384, cs.DIM), generator=g, device=dev)

    def cases():
        """(label, route key, state, row width, call(probes, form))"""
        full = cs.synthetic_state(torch, V, dev)
        D = full.dim
        yield "ivf_rerank int8+residual k=10", torch.int8, full, D, lambda pr, f: cs.in_form(
            IC, f, lambda: R.ivf_rerank(full, q[: pr.shape[0]], pr, 10))
        coarse = cs.one_slab(torch, full, torch.int8)
        yield "ivf_rerank_wave int8 k=40", torch.int8, coarse, D, lambda pr, f: cs.in_form(
            IC, f, lambda: TX.ivf_rerank_wave(coarse, q[: pr.shape[0]], pr, 40))
        del coarse
        for dtype in (torch.bfloat16, torch.float32):
            name = R._FORM_NAME[dtype]
            st = cs.one_slab(torch, full, dtype)
            yield f"ivf_rerank {name} k=10", dtype, st, D, lambda pr, f: cs.in_form(
                IC, f, lambda: R.ivf_rerank(st, q[: pr.shape[0]], pr, 10))
            if dtype == torch.float32:  # kernel 2's f32 slab takes the same route
                yield "ivf_rerank_wave f32 k=40", dtype, st, D, lambda pr, f: cs.in_form(
                    IC, f, lambda: TX.ivf_rerank_wave(st, q[: pr.shape[0]], pr, 40))
            aug = TX.augment_slab(st.vectors, st.norms, st.valid, "cosine")
            C = st.cluster_capacity
            for exact in (True, False) if dtype == torch.bfloat16 else (True,):
                yield (f"ivf_rerank_aug {name} exact={exact} k=10", ("aug", dtype), st,
                       aug.shape[1], lambda pr, f: cs.in_form(IC, f, lambda: TX.ivf_rerank_aug(
                           aug, C, q[: pr.shape[0]], pr, 10, exact=exact)))
            del st, aug
            torch.cuda.empty_cache()

    lost_at = {}
    for label, key, st, width, call in cases():
        if only and not any(o in label for o in only):
            continue
        for P in (2, 4):
            for B in (256, 512, 1024, 2048, 4096, 8192, 16384):
                pr = cs.synthetic_probes(torch, dev, B, st.num_clusters, 5, P=P)
                qms, cms, t = cs.form_turns(torch, lambda f: call(pr, f), 10)
                cols = B * P * IC.padded_dim(width)
                print(f"{label} P={P} B={B} (pairs x padded columns {cols}): per-query/cluster/"
                      f"cluster/per-query {'/'.join(f'{x:.3f}' for x in t)} ms; cluster / "
                      f"per-query {cms / qms:.3f}", flush=True)
                lost_at.setdefault(key, 0)
                if cms >= qms:
                    lost_at[key] = max(lost_at[key], cols)
    for key, cols in lost_at.items():
        print(f"{key}: the largest pairs x padded columns at which the cluster-major form "
              f"lost a case: {cols} (the route takes it from {IC.MIN_PAIR_COLUMNS[key]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
