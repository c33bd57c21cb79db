"""Time both kernel forms of the IVF probe re-ranks over batch sizes, to place
the route's crossover (``ops.ivf_cluster.MIN_PAIR_COLUMNS``).

Run from the repository root on a CUDA card:

    python zebra_tpu_torch/tools/ivf_crossover.py

The synthetic IVF state of ``chip_smoke.py`` (the main path's sizing:
K=16384, C=128, D=768, int8 + residual, ragged counts, tombstones) and its
coarse values as a bf16 slab; uniform random probes; B = 256 ... 16384 and
P = 2, 4; kernel 1 on int8 + residual and on bf16 (k=10), kernel 2 on int8
(k=40). Each line times the per-query form and the cluster-major form
(``chip_smoke.in_form`` pins one) in turns per-query, cluster, cluster, per-query, as
CUDA-event means over calls from the host, so the cluster-major form's
work-item builder counts with its launch overhead. The last line names the
smallest pairs x padded columns above which the cluster-major form won every
case measured.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    import chip_smoke as cs
    from zebra_tpu_torch.index import ivf as V
    from zebra_tpu_torch.ops import experimental_ivf as TX
    from zebra_tpu_torch.ops import ivf_cluster as IC
    from zebra_tpu_torch.ops import ivf_rerank as R

    if not torch.cuda.is_available():
        print("ivf_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((16384, cs.DIM), generator=g, device=dev)

    def cases():
        full = cs.synthetic_state(torch, V, dev)
        yield "ivf_rerank int8+residual k=10", full, lambda pr, f: cs.in_form(
            IC, f, lambda: R.ivf_rerank(full, q[: pr.shape[0]], pr, 10))
        coarse = cs.one_slab(torch, full, torch.int8)
        yield "ivf_rerank_wave int8 k=40", coarse, lambda pr, f: cs.in_form(
            IC, f, lambda: TX.ivf_rerank_wave(coarse, q[: pr.shape[0]], pr, 40))
        bf16 = cs.one_slab(torch, full, torch.bfloat16)
        del full, coarse
        torch.cuda.empty_cache()
        yield "ivf_rerank bf16 k=10", bf16, lambda pr, f: cs.in_form(
            IC, f, lambda: R.ivf_rerank(bf16, q[: pr.shape[0]], pr, 10))

    lost_at = 0
    for label, st, call in cases():
        for P in (2, 4):
            for B in (256, 512, 1024, 2048, 4096, 8192, 16384):
                pr = cs.synthetic_probes(torch, dev, B, st.num_clusters, 5, P=P)
                qms, cms, t = cs.form_turns(torch, lambda f: call(pr, f), 10)
                cols = B * P * IC.padded_dim(st.dim)
                print(f"{label} P={P} B={B} (pairs x padded columns {cols}): per-query/cluster/"
                      f"cluster/per-query {'/'.join(f'{x:.3f}' for x in t)} ms; cluster / "
                      f"per-query {cms / qms:.3f}", flush=True)
                if cms >= qms:
                    lost_at = max(lost_at, cols)
    print(f"the cluster-major form won every case above {lost_at} pairs x padded columns "
          f"(the route takes it from {IC.MIN_PAIR_COLUMNS} by slab type)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
