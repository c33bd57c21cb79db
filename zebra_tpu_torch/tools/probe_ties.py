"""How often an inserted row's own cell survives probe selection's stage 1,
on the text document path of ``chip_smoke.py`` (phase 12's data and
database), for two orders among equal bf16 scores.

    python zebra_tpu_torch/tools/probe_ties.py

Embeds phase 12's 262,144 synthetic documents with ``defaults.text_db``'s
tower on the card, inserts them with ``insert_records``, and for every row
takes its own cell (``slot // C``) and its own vector as the query. It
prints the share of rows whose own cell is among stage 1's top-n candidates
(n = 4 = 2P at P=2, 8, 16) when the top-n runs on the bf16-rounded scores
(``torch.topk``'s order among equal scores: the rule before the repair) and
on the f32 scores (the order of the bf16 scores with equal ones broken by
their f32 value: ``ivf.probe_candidates``), the share the exact f32
selection (``probe_sel="f32"``) probes at P=2, and, for the rows the bf16
order loses, how many cells share their own cell's bf16 score. Run from the
repository root; needs one CUDA card.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

CHUNK = 16384


def main() -> int:
    import shutil

    import torch

    import chip_smoke as cs
    import zebra_tpu_torch as zt
    from zebra_tpu_torch.index import ivf as V

    if not torch.cuda.is_available():
        print("probe_ties: needs a CUDA card", file=sys.stderr)
        return 1
    docs = cs.make_documents(cs.TEXT_DOCS, cs.SEED)
    tmp = tempfile.mkdtemp(prefix="probe_ties_")
    try:
        db = zt.text_db(os.path.join(tmp, "t.zebra"))
        t0 = time.perf_counter()
        vecs = db.model.embed_documents(docs)
        ids = db.insert_records(vecs, docs)
        print(f"probe_ties: {len(ids)} documents embedded and inserted in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        idx = db.index
        st, metric = idx.state, idx.metric
        cb, cn2 = V.probe_operands(st)
        own = torch.tensor([idx._id_to_slot.get(i) for i in ids],
                           device=idx.device) // st.cluster_capacity
        q_all = torch.from_numpy(vecs).to(idx.device)
        ns = (4, 8, 16)
        held = {("bf16", n): [] for n in ns} | {("f32", n): [] for n in ns}
        exact, ties = [], []
        for s in range(0, len(ids), CHUNK):
            q, mine = q_all[s : s + CHUNK], own[s : s + CHUNK, None]
            f32 = 2.0 * torch.mm(q.to(torch.bfloat16), cb.T, out_dtype=torch.float32) - cn2
            b16 = f32.to(torch.bfloat16)
            for n in ns:
                held[("bf16", n)].append((torch.topk(b16, n, dim=1).indices == mine).any(1))
                held[("f32", n)].append((torch.topk(f32, n, dim=1).indices == mine).any(1))
            exact.append((V.select_probes(st, q, 2, metric, probe_sel="f32") == mine).any(1))
            lost = ~held[("bf16", 4)][-1]
            ties.append((b16[lost] == b16[lost].gather(1, mine[lost])).sum(1))
        n_rows = len(ids)
        for (order, n), h in held.items():
            h = torch.cat(h)
            print(f"probe_ties: stage 1 top-{n} on the {order} scores holds the row's own cell "
                  f"for {float(h.float().mean()):.6f} of {n_rows} rows ({int((~h).sum())} lost)")
        h = torch.cat(exact)
        print(f"probe_ties: the exact f32 selection at P=2 probes it for "
              f"{float(h.float().mean()):.6f} ({int((~h).sum())} lost)")
        t = torch.cat(ties)
        if t.numel():
            print(f"probe_ties: the {t.numel()} rows the bf16 order loses at top-4 share their "
                  f"cell's bf16 score with {int(t.min())}-{int(t.max())} cells (median "
                  f"{int(t.median())}), their own included")
        print(f"probe_ties: K={st.num_clusters}, C={st.cluster_capacity}, metric {metric}; "
              f"{torch.cuda.get_device_name(0)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
