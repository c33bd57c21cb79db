"""Time both forms of the LSH re-rank kernel over candidate densities, to
place the dispatch rule's crossover (``ops.lsh_rerank.SLAB_SHARE``).

Run from the repository root on a CUDA card:

    python zebra_tpu_torch/tools/lsh_crossover.py

A random 1M-row prefix of a 768-wide f32 slab; sorted compacted candidate
rows in which each query holds a given share of the occupied rows
(``chip_smoke.lsh_dense_candidates``); B = 256 (one pass of the LSH path's
free-memory split at 1M rows) and B = 1024; k = 10. The slab-major form is
forced below the rule's share by raising ``SLAB_SHARE`` for the measurement.
Times are CUDA-event means, in turns gather, slab, slab, gather.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    import chip_smoke as cs
    from zebra_tpu_torch.ops import lsh_rerank as LR

    if not torch.cuda.is_available():
        print("lsh_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    occupied, D = cs.DENSE_OCCUPIED, cs.DIM
    g = torch.Generator(device=dev).manual_seed(4)
    slab = torch.randn((occupied + 4096, D), generator=g, device=dev)
    q = torch.randn((1024, D), generator=g, device=dev)
    rule = LR.SLAB_SHARE
    LR.SLAB_SHARE = 10**9  # every sorted f32 case takes the slab-major form
    kw = dict(sorted_slots=True, occupied=occupied)
    for share in (0.2, 0.1, 0.0625, 0.04, 0.03, 0.02, 0.01, 0.003):
        cand, norms, valid = cs.lsh_dense_candidates(torch, dev, slab, 1024, occupied, share, 11)
        for B in (256, 1024):
            args = (slab, q[:B], cand[:B].contiguous(), norms[:B].contiguous(),
                    valid[:B].contiguous())
            ms = [cs.time_ms(torch, lambda: LR.lsh_rerank(*args, k=10, **form), 3)
                  for form in ({}, kw, kw, {})]
            print(f"share {share}: M={cand.shape[1]} (occupied/M = {occupied / cand.shape[1]:.1f}; "
                  f"the rule takes the slab form at <= {rule}) B={B}: gather/slab/slab/gather "
                  + "/".join(f"{m:.3f}" for m in ms) + " ms", flush=True)
        del cand, norms, valid, args
    return 0


if __name__ == "__main__":
    sys.exit(main())
