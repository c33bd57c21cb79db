"""Quickstart on the PyTorch port: create, fill, query, persist a database.

Run: python examples/quickstart_torch.py [--device cpu]   (default: the CUDA card)
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import zebra_tpu_torch as z  # noqa: E402


def main(device: str = "cuda"):
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "demo.zebra")

    # --- documents with a deterministic offline model -----------------------
    cfg = z.DatabaseConfig(dim=64, metric="cosine", model="hash-64")
    db = z.Database.open_or_create(path, cfg, device=device)
    docs = [f"document {i} about topic {i % 7}".encode() for i in range(500)]
    db.insert_documents(docs)
    res = db.query_documents([docs[42]], number_of_results=3)
    print("nearest docs:", [d[:24] for d in res[0].values()])

    # --- raw vectors, exact (flat) index ------------------------------------
    vec_cfg = z.DatabaseConfig(dim=128, metric="sql2", index=z.IndexOptions(index_type="flat"))
    vdb = z.Database.create(os.path.join(tmp, "vecs.zebra"), vec_cfg, device=device)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((2000, 128)).astype(np.float32)
    ids = vdb.insert_vectors(data)
    rows = vdb.query(data[:2], number_of_results=5)
    print("self-match:", rows[0][0][0] == ids[0], "dist:", rows[0][0][1])

    # --- persistence round-trip ---------------------------------------------
    db2 = z.Database.open(path, device=device)
    print("reopened:", len(db2), "records; stats:", db2.index.stats())

    # --- maintenance ---------------------------------------------------------
    live_ids = db2.index.ids()
    db2.remove(live_ids[:10])
    db2.deduplicate()
    print("after remove+dedup:", len(db2))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(ap.parse_args().device)
