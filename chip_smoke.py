#!/usr/bin/env python3
"""Drive the torch port of zebra-tpu once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit); CUDA must be available
   and TF32 off;
2. build the six kernel sources from ``zebra_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together), and count the int-to-float
   conversions, byte permutes and tensor-core products in each library's
   machine code (``cuobjdump -sass``);
3. IVF kernel parity at its main path's shapes (D=768, C=128, P=2, k=10 and
   k=128, B=1024; ragged counts, tombstones, an all-invalid probe) against
   the plain torch version; the cluster-major form (``ivf_rerank_cluster.cu``)
   the same way at P=2, 3, 4 and with a hot cluster, three metrics,
   k=10/40/128, and its scoring and selection kernels each against their
   plain versions; both forms timed in turns at B=1024 and B=16384; then the
   forms without a residual on the same synthetic state (plain int8 with
   scales, the coarse values as bf16 and as f32; P=4, three metrics, k=10
   and 128, B=1024; the cluster-major form for int8 and bf16 at P=4/3 and a
   hot cluster, k=10/128, and for f32 (3xTF32) at P=4/3/2 and a hot
   cluster, k=10/40/128), each timed at B=16384, P=4 beside its bound, both
   forms in turns;
4. the IVF path at the library defaults: ``Database.create`` with
   ``DatabaseConfig(dim=768)``, ``insert_vectors`` of 1M rows (its stage
   table from ``db.stats`` and the stage timers, and which host quantiser
   ran: the native one must), ``query`` in batches of 1024 and
   ``query_stream`` over the same batches (equal batch for batch), recall@10
   against the exact scan, self-retrieval, ``remove``, a submit / mutate /
   collect check (collect equals the answer before the mutations) and
   ``deduplicate`` of 1000 planted copies (exactly those removed), ``save``
   and reopen, ``search_arrays``, ``search_stream``, ``db.query`` and
   ``query_stream`` at batch 16384 (the streams equal ``db.query``), one
   submit's timeline (no host sync under PyTorch's sync debug mode; the card
   still busy when it returns) and the host side of a batch (pinned and
   pageable uploads, the buffer fill, formatting) — and the kernel's launch
   count by form over it; then, on the path's own probes at B=1024 and 16384, both kernel
   forms against the plain version and in turns, probe selection's stage 1
   on the tensor cores against its plain version (times in turns, probe
   agreement with it and with the exact f32 probes), and the stages of one
   device query;
5. LSH kernel parity (D=768, B=1024, candidate widths 3000 and 65,536, k=10
   and k=128, three metrics, f32 and bf16 slabs; -1 pads, masked duplicates,
   an all-invalid query, a zero-norm row) against the plain torch version,
   and both timed at B=16384 at both widths (the gather form); then a sorted
   dense case for the slab-major form (B=1024, each query holding ~20% of
   1M occupied rows, compacted rows with -1 pads, a masked duplicate, a dead
   entry, the zero-norm row, an all-invalid query): slab form against the
   plain version, every differing rank held to an f64-verified tie, and both
   forms timed, on the f32 slab and on its bf16 copy;
6. the LSH path at its library defaults: ``DatabaseConfig(dim=768,
   index=IndexOptions(index_type="lsh"))``, ``insert_vectors`` of the same 1M
   rows, ``query`` in batches of 1024, recall@10 against the exact scan,
   self-retrieval, ``remove``, ``save`` and reopen, ``search_arrays`` at
   batch 16384, with the pipelined checks of phase 4 (``query_stream`` at
   1024 and at 16384 in two batches; no ``search_stream``), the kernel's
   launch count over it, all of the slab-major
   form; then, on the path's own candidates of 1024 held-out queries (deep
   buckets are compacted losslessly, see ``index/lsh.py``), both forms of
   the kernel against the plain version at k=10 and k=128, the forms timed
   in turns (gather, slab, slab, gather) beside the plain version and the
   bound, the stages of one device query timed by CUDA events, and the LSH
   search beside the exact scan;
7. one-slab wave kernel parity on the synthetic state of phase 3 (int8 with
   scales, bf16 and f32 slabs, three metrics, k=10/40/128, P=4 and an odd
   P=3, B=1024) against the plain torch version, per-query form and
   cluster-major form (also P=2 and a hot cluster), and both forms timed in
   turns at B=1024 and 16384, P=4, k=40 on the int8 and the f32 slab;
8. the gather-refine path: ``DatabaseConfig(dim=768, index=IndexOptions(
   refine=4, rerank="pallas2"))`` through the same facade calls and checks as
   phase 4 (the wave kernel's launch count by form over it; the probe kernel
   must not run); then, on the path's own probes, both forms of the wave
   kernel against its plain version and in turns, probe selection as in
   phase 4, the stages of one device query timed by CUDA events, the
   distinct probed blocks beside B*P, and the recall of phase 4's scan-mode
   database beside this one's, both against this phase's exact scan;
9. the augmented-slab surface at the same sizing (K=16384, C=128, D=768,
   P=4; all-live random rows with a share of tombstones; bf16, then f32):
   ``augment_slab`` -> ``ivf_rerank_aug`` driven as the JAX package's
   ablation tool drives it, at B=1024 and B=16384, ``exact`` on and off
   (its launch count by form: the route sends B=16384 to the cluster-major
   form), each driven result held against the plain version on the same
   inputs (every differing rank an f64-verified tie); then both kernel
   forms against the plain version on the path's probes and on a hot
   cluster (three metrics, k=10/128, ``exact`` on and off, B=1024), the
   cluster-major form's scoring and selection kernels each against their
   plain versions at B=1024 (a hot cluster) and B=16384, and both forms
   timed in turns at B=1024 and B=16384, ``exact`` on and off, beside the
   plain version and the bound;
10. the bf16 "balanced" tier: ``DatabaseConfig(dim=768,
   index=IndexOptions.tier("balanced"))`` through the same facade calls and
   checks as phase 4 (the probe kernel's bf16 forms; their launch count
   over the path), then, on the path's own probes, as phase 4;
11. the f32 tier: ``DatabaseConfig(dim=768,
   index=IndexOptions(dtype="float32"))`` (f32 slab, P=4, f32 query wire)
   through the same facade calls and checks as phase 4 (the probe kernel's
   f32 forms; their launch count over the path), then, on the path's own
   probes, as phase 4;
12. the text document path: ``defaults.text_db`` (384 dimensions, sql2,
   BGE-small-en-v1.5 at its published widths on the card, f32 with TF32
   off; IVF at the library defaults) on 65,536 synthetic documents of 8-60
   words from a 30,000-word vocabulary plus 4,096 held-out queries (one
   seeded generator): ``model_status()``, the native store and the packed
   backend; the card's tower against the CPU tower with the same weights on
   256 documents (max abs difference <= 1e-4), one document bitwise equal
   alone, at another row and in another batch size, the forward time of a
   batch of 64 beside its f32 bound; ``insert_documents`` (durability
   "full"; the stage table with ``insert.embed`` and ``insert.blobs``);
   ``query_documents`` of the held-out queries in batches of 1024 (the rate
   with ``query.embed`` split out, every document equal to the inserted
   bytes of its id, the blob reads timed alone); self-retrieval of 1024
   documents, ``remove`` of 1000 (never returned, their blobs gone),
   ``deduplicate`` of 1000 copies planted by a later insert (exactly those
   removed); ``save``, ``close`` and reopen (same top-10 and blobs);
   ``db.query`` at batch 16384 (kernel 1's launch count by form: both forms
   present) and every live row whose top-1 there is not its own id, with
   its probes, own cell or the spare, its own f64 distance beside the
   rank-1 row's and the top-1 of the per-query form, the cluster form, the
   plain version and the exact scan (each a duplicate, an f64 tie, a row
   spilled out of its nearest cells, or its own cell dropped by stage 1 of
   probe selection as ``stage1_witness`` recomputes it exactly); the CLI
   (text insert, stats and clear through its ``main`` here, ``python -m
   zebra_tpu_torch.cli`` text query in a process of its own) and the verify skill's
   ``hash-64`` drive;
   then the facade's top-10 of every held-out query against kernel 1's
   plain version on the same index and probes (differing ranks f64-verified
   ties), recall@10 against the exact scan at P=2, 4 and 8 (printed, no
   guard: random-init text embeddings are crowded), and, on the path's own
   probes at B=1024 and 16384, both forms of kernel 1 against the plain
   version and in turns beside the bound, as phase 4. Cut (the run's
   time): 32,768 documents, where it once inserted 262,144 (65,536 before
   phase 16 joined), and the CLI's insert, stats and clear in this
   process, not in three more processes.
13. a growing database at the library defaults (``DatabaseConfig(dim=768)``,
   durability "full"): the same 1M rows in 16 ``insert_vectors`` calls of
   62,500; after each call the reason the index wants, whether a retrain
   or a fold runs, K, the spare, the exact scan's top-1 for 1024 of the
   rows just inserted (1.0, also for rows landing while a retrain builds),
   recall@10 of 1024 held-out queries and the self-retrieval of 1024 fresh
   and 1024 of all rows, one batch's CUDA-event time while a retrain runs;
   each retrain held against a cold build of its rows (K, C, the k-means
   objective, recall and self-retrieval) and the first one against the JAX
   facade's CPU reading on the same rows (``tests/growth_parity.py``);
   then the retrains (started, committed, drained on the mutating thread,
   each reason, size and wall time, the ``retrain.*`` stages), the folds
   and the log left, one batch's time after them, the final K beside a
   cold build's, kernel 1's launches by form (both present), a reopen
   beside the live database (the log replayed) and one after ``close``
   (same top-10 of 1024 held-out queries), and an explicit
   ``index.rebuild()`` (every row kept, the exact top-10 unchanged, a cold
   build's K and recall; self-retrieval 1.0, or every miss a stage-1
   rounding drop that ``stage1_witness`` confirms, printed by
   ``fault_c_report``). Nothing is cut.
14. the flat tier and the elementwise metrics on phase 4's rows: the exact
   tier (``IndexOptions.tier("exact")``: flat, an f32 slab) through the
   facade (a durable insert of 1M rows; ``search_arrays`` top-10 of 1024
   held-out queries held to an f64 scan, every rank within TIE_TOL, so
   every differing id an f64 tie; its device time beside its bound;
   ``exact_precision="default"``'s time and agreement; self-retrieval,
   removes, save and reopen); the nine elementwise metrics through
   ``ops.scan.exact_scan`` on the same slab for 64 queries, each held to
   an f64 scan and timed beside its bound; IVF at the defaults with
   ``metric="manhattan"`` (recall@10 against ``ivf.brute_force``,
   self-retrieval, kernel 1 never launched); LSH with ``metric="l3"`` on
   65,536 rows, the card's top-10 against the CPU's on the same saved
   index;
15. the image and audio document paths: which media libraries the machine
   has (Pillow required); 8,192 + 1,024 seeded synthetic JPEGs through
   ``defaults.image_db``, 6,144 + 512 seeded 2 s clips (WAV, 512 FLAC twins
   by ``tests/flac_encoder.py``) and 768 + 64 seeded clips that fill
   the tower's 30 s window through ``defaults.audio_db`` (ViT-base/16
   ``embeddings_mean`` on the card, IVF at the defaults), each held as
   phase 12 holds the text path (the card's tower against the CPU's,
   batch invariance, the insert's stages, ``query_documents``,
   self-retrieval, removes, ``deduplicate`` of planted copies, reopen, the
   stored rows at once, the facade against kernel 1's plain version, both
   forms on the path's probes). The 2 s clips crowd within ~1e-5 of each
   other, so their self-retrieval and parity are printed as not counted
   where their queries probe under MIN_PROBED_SHARE of the cells; the 30 s
   clips must reach it. Also the spectrogram card vs CPU and every FLAC
   twin bitwise its WAV clip; the
   full encoder registered as a custom model (2,048 images; the forward of
   a padded batch of 32 beside its f32 bound; card vs CPU); the CLI's
   ``image insert``, ``image query --preview`` and ``audio query --play``
   in this process;
16. (run after phase 14, on phase 4's rows) the sharded database:
   ``DatabaseConfig(dim=768, shards=4)`` with ``device="cuda"`` (four IVF
   states at the defaults, K=16384 and C=32 each, on this card): a durable
   insert of the 1M rows in one call, the 16,384 held-out queries at batch
   1024 and 16384 through ``search_arrays`` and ``db.query`` (recall@10
   against the sharded exact scan), self-retrieval of 1024 rows, removes,
   kernel 1's launches by form and by shard over that drive; shard 0's
   kernel in both forms against its plain version on its own probes; the
   device query and the merge of the partials by CUDA events; save and
   reopen (the same top-10), a reshard on load to 2 shards (the same exact
   top-10, recall); LSH over 4 shards on the first 131,072 rows (recall,
   kernel 4's launches); BGE-small and ViT ``embeddings_mean``
   tensor-parallel on a (data=2, model=4) grid of this card against the
   single-device towers;
17. (run after phase 16, on phase 4's first 262,144 rows) kill and reopen:
   three writer processes each create ``DatabaseConfig(dim=768)`` on the
   card and insert the rows in 8 calls of 32,768, logging each
   acknowledged call's ids to an fsync'd side file; this process SIGKILLs
   (a) one halfway through its 6th call, (b) one just after an
   acknowledged remove of 1,000 of its ids, (c) one half a second after
   its background log fold starts (or after its last call where none
   starts, which is printed), then reopens each on the card and checks:
   every acknowledged insert live and its row's exact top-1 (certified
   from bf16 products, else an f64 scan) its own id within 1e-4, no
   acknowledged remove live or returned, the call in flight present only
   as a prefix of whole spans (16,384 rows at this call size), the length,
   and ``db.query`` of 1,024 acknowledged rows through kernel 1 (each its
   own id; a miss classified by ``fault_c_report``), kernel 1 on those
   probes against its plain version; the phase's and each replay's
   seconds.

Each facade path waits for its background retrain and log fold before it
times anything and prints the waits (``settle``).

Every IVF path must launch the cluster-major form (its batch-16384
queries take it by ``ivf_cluster.takes_cluster_form``). Phases 3, 9 and 11
have no fallback: a kernel that fails to build or launch raises.

A kernel's ``bound_ms`` is the larger of its distinct bytes (every input
byte once, every output byte once) over 3.35 TB/s and its operations over
the card's peak rate for their type, both counted from the timed inputs.
A line ``pipeline: {...}`` holds each path's insert stage table, stream
QPS, submit timeline and dedup time (and the text path's stage table,
rates, forward time and recall). The second-to-last line is the kernels'
JSON record (every kernel carries its ``forms``; kernel 1 has further
entries for the text path at D=384, sql2, for the image path and the
two audio databases, and for the databases reopened after the kills), the
last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

N_ROWS = 1_000_000
DIM = 768
N_QUERIES = 16384
SEED = 0
#: kernel-vs-plain tolerance: f32 dots summed in another order
RTOL = ATOL = 1e-4
MIN_SLOT_AGREEMENT = 0.999
#: probe selection's stage 1 on the tensor cores against its plain version
#: (the same products, summed in another order): share of the B*P probes
MIN_PROBE_AGREEMENT = 0.999
#: where kernel and plain pick different candidates at a rank, the two
#: picks' distances recomputed in f64 must agree within this (relative to
#: 1 + |d|): a swap of near-equal distances by f32 summation order
TIE_TOL = 1e-5
MIN_RECALL = 0.95
#: published peaks of one H100 SXM: device memory, f32 outside the tensor
#: cores, bf16 on them
HBM_BYTES_S = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
#: rows the dense synthetic LSH case holds per query, of its occupied rows
DENSE_OCCUPIED = 1_000_000
DENSE_SHARE = 0.2
#: LSH guards, not targets: a broken bucket scatter measured 0.48 on the TPU
MIN_LSH_RECALL = 0.85
MIN_LSH_SELF = 0.99
#: base rows the submit / mutate / collect check queries and removes, and
#: the base rows it inserts again as exact copies for deduplicate to find
MUTATE_QUERY_ROWS = slice(5000, 6024)
MUTATE_REMOVE_ROWS = slice(5000, 5010)
DUP_ROWS = slice(200_000, 201_000)
#: times the stream phases send the held-out batch of 16384
STREAM_REPEATS = 4
#: phase 12: synthetic documents, held-out queries, the vocabulary they are
#: drawn from and their length in words (the documents cut from 262,144 to
#: 65,536 when phases 14 and 15 joined the run, to 32,768 when phase 16 did)
TEXT_DOCS = 32_768
TEXT_QUERIES = 4_096
TEXT_VOCAB = 30_000
TEXT_WORDS = (8, 60)
#: the card's tower against the CPU tower with the same weights (unit vectors)
TEXT_TOWER_ATOL = 1e-4
#: documents phase 12 removes, and those it inserts again as exact copies
TEXT_REMOVE = slice(1000, 2000)
TEXT_DUP_ROWS = slice(5000, 6000)
#: phase 13: calls that insert the growing database's rows, the first 1/16
GROWTH_CALLS = 16
#: phase 13: what a retrain built against a cold build of the same rows with
#: its own k-means draws: the objective's relative excess, and how far below
#: the cold build's recall and self-retrieval it may read (the card's
#: retrains read -0.032 to +0.026 of it, a spread of 0.018 about -0.007,
#: over two runs of six readings)
GROWTH_OBJECTIVE_TOL = 0.02
GROWTH_COLD_TOL = 0.08
#: phase 13's first retrain (spare-critical at 187,500 rows) as the JAX
#: package's facade answers after the same rows and calls on the CPU
#: (``JAX_PLATFORMS=cpu python tests/growth_parity.py --package jax --dim 768
#: --calls-run 3``), and how far below it the card's port may read (the
#: port's own CPU run of the same drive reads within 0.017 of it there and
#: within 0.044 the call before: other k-means draws)
GROWTH_JAX = {"live": 187_500, "recall": 0.88349609375, "fresh": 0.8779296875,
              "self": 0.9072265625}
GROWTH_JAX_TOL = 0.06
#: phase 14: held-out queries of the exact tier, of each elementwise scan and
#: of the IVF manhattan recall; rows of the LSH l3 case
FLAT_QUERIES = 1_024
METRIC_QUERIES = 64
IVF_METRIC_QUERIES = 256
LSH_METRIC_ROWS = 65_536
ELEMENTWISE = ("chebyshev", "canberra", "braycurtis", "manhattan", "l3", "l4", "hamming",
               "minkowski", "p_norm")
#: f32 operations an element of each elementwise metric does (its ops bound):
#: the difference, its magnitude and the reduction, plus the metric's own
ELEMENT_OPS = {"chebyshev": 3, "canberra": 8, "braycurtis": 5, "manhattan": 3, "l3": 5,
               "l4": 5, "hamming": 12, "minkowski": 4, "p_norm": 4}
#: phase 15: synthetic images inserted and held out, clips inserted and held
#: out (2 s at 16 kHz), FLAC twins of the first clips, clips that fill the
#: tower's 30 s window inserted and held out, images of the encoder
#: database; the card's towers against the CPU's, the spectrogram likewise
#: (images 16,384 -> 8,192, 2 s clips 8,192 -> 6,144, 30 s clips 1,024 -> 768
#: when phase 16 joined the run)
IMAGE_DOCS = 8_192
IMAGE_QUERIES = 1_024
AUDIO_DOCS = 6_144
AUDIO_QUERIES = 512
AUDIO_RATE = 16_000
AUDIO_SAMPLES = 32_000
AUDIO_FLAC = 512
WIDE_DOCS = 768
WIDE_QUERIES = 64
WIDE_SAMPLES = 480_000
ENCODER_DOCS = 2_048
MEDIA_TOWER_ATOL = 1e-4
SPECTROGRAM_ATOL = 1e-5
#: an audio database's self-retrieval and parity count only where the
#: self-retrieval queries probe at least this share of its cells: 2 s clips
#: in the 30 s window through the random-init tower all embed within ~1e-5
#: of each other (cosine) and probe a handful of cells, where every answer
#: is an f64 tie of every other and no check of them can fail
MIN_PROBED_SHARE = 0.25
#: phase 16: shards of the sharded databases (all on the one card), rows of
#: its LSH database (the first of phase 4's rows, cut from 1M for the run's
#: time), rows it removes, the documents and images its tensor-parallel
#: towers embed and their ("data", "model") grid; the towers against the
#: single-device ones on the card
SHARDS = 4
SHARD_LSH_ROWS = 131_072
SHARD_REMOVE = slice(3000, 4000)
TP_DOCS = 256
TP_IMAGES = 64
TP_GRID = (2, 4)
TP_ATOL = 1e-4
#: phase 17: rows each killed writer inserts (phase 4's first rows), in
#: calls of equal size; the call during which writer (a) is killed, after
#: this share of its previous call's seconds; the acknowledged ids writer
#: (b) removes after its 4th call; the seconds writer (c) runs on after it
#: sees the log fold start; the acknowledged rows each reopened database
#: queries; the cosine distance a row may stand from its stored value (the
#: int8 + residual reconstruction: ~1e-6); the bound on a bf16 product of
#: unit vectors' error that certifies an exact top-1 (bf16 operands round
#: each factor by 2^-9: at most 2^-8 of the product, f32 sums far less);
#: the writers' time limit
KILL_ROWS = 262_144
KILL_CALLS = 8
KILL_IN_CALL = 5
KILL_IN_CALL_SHARE = 0.5
KILL_REMOVE = 1_000
KILL_FOLD_DELAY_S = 0.5
KILL_QUERY = 1_024
KILL_SELF_TOL = 1e-4
KILL_BF16_ERR = 2.0 ** -7
KILL_CHILD_TIMEOUT_S = 150
#: documents phase 15 removes, and those it inserts again as exact copies
#: (the 30 s clips: WIDE_*)
MEDIA_REMOVE = slice(1000, 1256)
MEDIA_DUP_ROWS = slice(5000, 5256)
WIDE_REMOVE = slice(100, 164)
WIDE_DUP_ROWS = slice(500, 564)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def synthetic_state(torch, V, device, K=16384, C=128, G=65536, D=DIM, seed=SEED):
    """A random int8 + residual IVF state at the main path's sizing, with
    ragged counts, tombstones, an all-tombstoned cluster (0), an empty
    cluster (1) and one zero-norm row."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = K * C + G
    st = V.empty_state(torch.zeros((K, D), device=device), C, G, dtype=torch.int8, refine=True)
    st.vectors.copy_(torch.randint(-127, 128, (S, D), generator=g, device=device, dtype=torch.int8))
    st.residual.copy_(torch.randint(-127, 128, (S, D), generator=g, device=device, dtype=torch.int8))
    st.scales.copy_(0.01 + 0.04 * torch.rand(S, generator=g, device=device))
    st.rscales.copy_(st.scales / 127.0)
    counts = torch.randint(0, C + 1, (K,), generator=g, device=device, dtype=torch.int32)
    counts[0], counts[1], counts[2] = C, 0, C // 2
    st.counts[:K] = counts
    row = torch.arange(K * C, device=device)
    live = (row % C) < counts.repeat_interleave(C)
    live &= torch.rand(K * C, generator=g, device=device) > 0.1  # tombstones
    live[:C] = False  # cluster 0: every row tombstoned
    live[2 * C] = True
    st.valid[: K * C] = live
    st.vectors[2 * C], st.residual[2 * C] = 0, 0  # a zero-norm row
    for s in range(0, S, 65536):
        x = (st.vectors[s : s + 65536].float() * st.scales[s : s + 65536, None]
             + st.residual[s : s + 65536].float() * st.rscales[s : s + 65536, None])
        st.norms[s : s + 65536] = (x * x).sum(-1)
    return st


def synthetic_probes(torch, device, B, K, seed, P=2):
    g = torch.Generator(device=device).manual_seed(seed)
    p0 = torch.randint(0, K, (B,), generator=g, device=device)
    cols = [p0] + [(p0 + torch.randint(1, K, (B,), generator=g, device=device)) % K
                   for _ in range(P - 1)]
    probes = torch.stack(cols, 1)
    probes[0] = torch.tensor([0, 1] * P, device=device)[:P]  # nothing valid at all
    probes[1, 1] = 0  # one all-invalid probe
    probes[2, 0] = 2  # the zero-norm row's cluster
    return probes


def compare(torch, got, want):
    """(slot agreement, max |dist err|) of kernel vs plain; raises on a
    validity mismatch or a distance outside the tolerance."""
    (dg, sg, vg), (dw, sw, vw) = got, want
    check(torch.equal(vg, vw), "kernel and plain disagree on which results are valid")
    check(bool(torch.isinf(dg[~vg]).all()) and bool((sg[~vg] == -1).all()),
          "missing results must be +inf / -1")
    agree = float((sg == sw).float().mean())
    err = float((dg[vg] - dw[vw]).abs().max()) if bool(vg.any()) else 0.0
    check(bool(torch.allclose(dg[vg], dw[vw], rtol=RTOL, atol=ATOL)),
          f"distances differ beyond rtol=atol={RTOL}: max abs err {err}")
    return agree, err


def metric64(torch, metric, dot, qn2, n2):
    """The kernels' distance formula in f64."""
    if metric == "cosine":
        return 1.0 - dot / torch.sqrt(torch.clamp(qn2 * n2, min=1e-30))
    d2 = torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0)
    return torch.sqrt(d2) if metric == "l2" else d2


def tie_gap(torch, got, want, d64):
    """(ranks where kernel and plain pick different candidates, the largest
    gap between the two picks' values recomputed in f64 by ``d64(b, pick)``,
    relative to 1 + |d|); raises if a gap exceeds TIE_TOL."""
    b, r = torch.nonzero(got != want, as_tuple=True)
    if b.numel() == 0:
        return 0, 0.0
    dg, dw = d64(b, got[b, r]), d64(b, want[b, r])
    gap = float(((dg - dw).abs() / (1.0 + dw.abs())).max())
    check(gap <= TIE_TOL, f"kernel and plain pick candidates {gap} apart (> {TIE_TOL}): "
          "not a tie")
    return b.numel(), gap


def lsh_d64(torch, vectors, q, cand, norms, metric):
    """f64 distance of query ``b``'s candidate at position ``pos``."""
    def d64(b, pos):
        qq = q[b].double()
        dot = (vectors[cand[b, pos].long(), : q.shape[1]].double() * qq).sum(-1)
        return metric64(torch, metric, dot, (qq * qq).sum(-1), norms[b, pos].double())
    return d64


def slab_d64(torch, st, qq, metric, residual=False):
    """f64 distance of query ``b`` to slab slot ``slot`` on one slab (with
    ``residual``, on the int8 + residual reconstruction), ``qq`` the query as
    the kernel multiplies it (the wave re-rank's is bf16-rounded on reduced
    slabs: ``TX._wave_query``)."""
    def d64(b, slot):
        x = st.vectors[slot].double()
        if st.scales is not None:
            x = x * st.scales[slot].double()[:, None]
        if residual and st.residual is not None:
            x = x + st.residual[slot].double() * st.rscales[slot].double()[:, None]
        qb = qq[b].double()
        return metric64(torch, metric, (x * qb).sum(-1), (qb * qb).sum(-1),
                        st.norms[slot].double())
    return d64


def bound_ms(n_bytes: float, n_ops: float, peak: float):
    """(least time in ms, "bytes" or "operations"): distinct bytes over the
    memory rate against operations over ``peak``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_bound(torch, st, probes, B, k, peak: float, residual: bool = False):
    """Bound of a probe re-rank on these inputs. Bytes: the queries, probes
    and results, and every DISTINCT probed block once — its count, the
    validity flags of its allocated prefix and, per live row, its D slab
    elements (and scale, on int8), its norm and, with ``residual``, D more
    code bytes and a scale. Operations: 2*D per slab for every (query,
    probe, live row). Also returns the distinct blocks and the bytes of
    every (query, probe) pair reading its own live rows."""
    K, C, D = st.num_clusters, st.cluster_capacity, st.dim
    live = (st.valid[: K * C].view(K, C)
            & (torch.arange(C, device=probes.device) < st.counts[:K, None])).sum(1)
    blocks = torch.unique(probes)
    n_live = float(live[blocks].sum())
    row = (D * st.vectors.element_size() + (4 if st.scales is not None else 0) + 4
           + (D + 4 if residual else 0))
    n_bytes = (B * D * 4 + probes.numel() * 4 + B * k * 12 + blocks.numel() * 4
               + float(st.counts[blocks.long()].sum()) + n_live * row)
    pairs = float(live[probes].sum())
    return (bound_ms(n_bytes, pairs * 2 * D * (2 if residual else 1), peak),
            int(blocks.numel()), pairs * row)


def time_ms_host(fn, reps: int, torch=None) -> float:
    """Mean host-clock ms of ``fn`` over ``reps`` runs after one warm-up
    (with ``torch``: synchronised after each run)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        if torch is not None:
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold(torch, got, want, d64, min_agree=MIN_SLOT_AGREEMENT):
    """(slot agreement, max |dist err|, differing ranks, largest f64 gap) of
    a kernel against its plain version: validity equal, distances within
    RTOL/ATOL, agreement at least ``min_agree`` and every differing rank an
    f64-verified tie. On a path's clustered data neighbours sit within the
    summation order's rounding, so the path phases hold ties alone
    (``min_agree=0``), as they always have."""
    agree, err = compare(torch, got, want)
    check(agree >= min_agree, f"slot agreement {agree} < {min_agree}")
    swaps, gap = tie_gap(torch, got[1], want[1], d64)
    return agree, err, swaps, gap


def cluster_cases(torch, device, B, K, seed, Ps):
    """Probe sets for the cluster-major form: for each P the synthetic probes
    (an all-invalid query, an all-invalid probe, the zero-norm row's
    cluster, ragged blocks), then a hot cluster that every query but query 0
    probes first (split over many work items)."""
    out = []
    for P in Ps:
        probes = synthetic_probes(torch, device, B, K, seed + P, P=P)
        out.append((f"P={P}", probes))
    hot = out[0][1].clone()
    hot[1:, 0] = 7
    out.append((f"P={hot.shape[1]} hot cluster", hot))
    return out


def cluster_form_parity(torch, call, ref, d64, cases, ks):
    """The cluster-major form (``call(probes, k, metric)``) against the
    plain version (``ref``) over ``cases`` x three metrics x ``ks``; returns
    (worst agreement, max abs err, differing ranks, cases run)."""
    worst, err_t, swaps_t, n = 1.0, 0.0, 0, 0
    for label, probes in cases:
        for metric in ("cosine", "l2", "sql2"):
            for k in ks:
                got = call(probes, k, metric)
                agree, err, swaps, _ = hold(torch, got, ref(probes, k, metric), d64(metric))
                if not label.endswith("hot cluster"):
                    check(not bool(got[2][0].any()), "query 0 probes only invalid rows")
                worst, err_t = min(worst, agree), max(err_t, err)
                swaps_t, n = swaps_t + swaps, n + 1
    return worst, err_t, swaps_t, n


def cluster_kernels_alone(torch, IC, st, q, probes, k, metric, round_q, residual, reps=10):
    """The cluster-major form's kernels one at a time on the same inputs: the
    items kernel against ``IC.work_items`` (equal), the scoring kernel's
    buffer against ``IC.score_reference`` (+inf on the same entries, live
    distances within RTOL/ATOL) and the selection kernel against
    ``IC.select_reference`` on that buffer (equal). Returns the times in ms
    of the pairs' sort alone, of sort + items + staging + scoring, and of the
    selection kernel."""
    pr = probes.to(torch.int32).contiguous()
    qc = q.float().contiguous()
    got_items = IC.items(pr, st.num_clusters, IC.ITEM_QUERIES)
    want_items = IC.work_items(pr, st.num_clusters, IC.ITEM_QUERIES)
    check(all(torch.equal(a, b) for a, b in zip(got_items, want_items)),
          "items kernel differs from its plain version")
    dist = IC.score(st, qc, pr, metric, round_q, residual)
    want = IC.score_reference(st, qc, pr, metric, round_q, residual)
    live = ~torch.isinf(want)
    check(torch.equal(live, ~torch.isinf(dist)), "scoring kernel: +inf on other entries")
    check(bool(torch.allclose(dist[live], want[live], rtol=RTOL, atol=ATOL)),
          "scoring kernel: distances beyond RTOL/ATOL")
    got = IC.select(dist, pr, st.cluster_capacity, k)
    ref = IC.select_reference(dist, pr, st.cluster_capacity, k)
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          "selection kernel differs from its plain version")
    sort_ms = time_ms(torch, lambda: IC.sort_pairs(pr, st.num_clusters), reps)
    score_ms = time_ms(torch, lambda: IC.score(st, qc, pr, metric, round_q, residual), reps)
    select_ms = time_ms(torch, lambda: IC.select(dist, pr, st.cluster_capacity, k), reps)
    del dist, want, got, ref
    return sort_ms, score_ms, select_ms


def in_form(IC, form, call):
    """``call()`` with the route between the two kernel forms pinned:
    "cluster" sends every shape the cluster-major form fits to it, "query"
    sends every shape to the per-query kernels (for holding and timing both
    forms on the same inputs)."""
    saved = IC.MIN_PAIR_COLUMNS
    IC.MIN_PAIR_COLUMNS = {k: 0 if form == "cluster" else 1 << 62 for k in saved}
    try:
        return call()
    finally:
        IC.MIN_PAIR_COLUMNS = saved


def form_turns(torch, call, reps):
    """``call(form)`` timed in turns: per-query, cluster, cluster, per-query.
    Returns (per-query ms, cluster ms, the four times)."""
    t = [time_ms(torch, lambda: call(f), reps) for f in ("query", "cluster", "cluster", "query")]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def cluster_timing(torch, IC, st, q, probes, k, metric, call, round_q, residual, peak, label,
                   reps=20):
    """Both forms of a re-rank timed in turns on the same inputs, the
    cluster-major form's kernels alone, and the bound; prints one line and
    returns the records of the two forms."""
    B = probes.shape[0]
    qms, cms, t = form_turns(torch, call, reps)
    sort_ms, score_ms, select_ms = cluster_kernels_alone(
        torch, IC, st, q, probes, k, metric, round_q, residual)
    (bound, by), blocks, stream = probe_bound(torch, st, probes, B, k, peak, residual=residual)
    print(f"timing: {label} B={B} P={probes.shape[1]} k={k}, in turns per-query/cluster/"
          f"cluster/per-query {'/'.join(f'{x:.3f}' for x in t)} ms; cluster form's parts: "
          f"sort {sort_ms:.3f}, sort + items + staging + scoring {score_ms:.3f}, selection "
          f"{select_ms:.3f} ms; bound {bound:.3f} ms by {by} ({blocks} distinct blocks of "
          f"{probes.numel()} probes); cluster / per-query {cms / qms:.3f}")
    rec = {"bound_ms": bound, "bound_by": by}
    return ({**rec, "ms": qms}, {**rec, "ms": cms, "select_ms": select_ms,
                                 "score_ms": score_ms, "sort_ms": sort_ms})


def print_sass_counts(libs) -> None:
    """Per built library, the instructions of its machine code that bear on
    the cost of int8 codes: I2F / I2FP (int -> float conversions), PRMT (byte
    permutes), HMMA / IMMA (tensor-core products). Read with ``cuobjdump
    -sass`` where the toolkit has it."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found; not counted")
        return
    for name, lib in libs.items():
        sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                              timeout=120).stdout
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", sass,
                         flags=re.M)
        count = {op: sum(o == op for o in ops) for op in ("I2F", "I2FP", "PRMT", "HMMA", "IMMA")}
        print(f"sass {name}: {len(ops)} instructions, " + ", ".join(
            f"{op} {n}" for op, n in count.items()))


def kernel_parity(torch, V, R, IC, device, B=1024, B_time=N_QUERIES):
    """Phase 3: kernel 1 against its plain version in each slab form at the
    main path's shapes, per-query form and cluster-major form, both timed in
    turns; returns each form's record by "<slab form>/<kernel form>"."""
    st = synthetic_state(torch, V, device)
    K = st.num_clusters
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    q = torch.randn((B, st.dim), generator=g, device=device)
    probes = synthetic_probes(torch, device, B, K, SEED + 2)
    worst_err = 0.0
    for metric, k in (("cosine", 10), ("l2", 10), ("sql2", 10), ("cosine", 128)):
        got = in_form(IC, "query", lambda: R.ivf_rerank(st, q, probes, k, metric))
        want = R.ivf_rerank_reference(st, q, probes, k, metric, dots="highest")
        agree, err = compare(torch, got, want)
        print(f"parity: {metric} k={k} B={B}: slot agreement {agree:.6f}, "
              f"max abs err {err:.3g}, valid results {int(got[2].sum())}")
        check(agree >= MIN_SLOT_AGREEMENT, f"slot agreement {agree} < {MIN_SLOT_AGREEMENT}")
        check(not bool(got[2][0].any()), "query 0 probes only invalid rows")
        worst_err = max(worst_err, err)
    # the cluster-major form: P = 2, 3, 4 and a hot cluster, three metrics, k = 10/40/128
    cases = cluster_cases(torch, device, B, K, SEED + 20, (2, 3, 4))
    agree_c, err_c, swaps_c, n_c = cluster_form_parity(
        torch, lambda pr, k, m: in_form(IC, "cluster", lambda: R.ivf_rerank(st, q, pr, k, m)),
        lambda pr, k, m: R.ivf_rerank_reference(st, q, pr, k, m),
        lambda m: slab_d64(torch, st, q, m, residual=True), cases, (10, 40, 128))
    print(f"parity: ivf_rerank cluster-major form, int8 + residual, P=2/3/4 and a hot "
          f"cluster x 3 metrics x k=10/40/128 ({n_c} cases), B={B}: worst slot agreement "
          f"{agree_c:.6f}, max abs err {err_c:.3g}; {swaps_c} differing ranks, all ties "
          f"(f64 gap <= {TIE_TOL})")
    qt = torch.randn((B_time, st.dim), generator=g, device=device)
    forms = {}
    for Bt in (B, B_time):
        pt = synthetic_probes(torch, device, Bt, K, SEED + 3)
        qc = q if Bt == B else qt
        rq, rc = cluster_timing(
            torch, IC, st, qc, pt, 10, "cosine",
            lambda f: in_form(IC, f, lambda: R.ivf_rerank(st, qc, pt, 10, "cosine")), False, True,
            PEAK_F32,
            "ivf_rerank int8 + residual (synthetic, live fill "
            f"{float(st.valid[: K * st.cluster_capacity].float().mean()):.3f})")
        if Bt == B_time:
            plain_ms = time_ms(torch, lambda: R.ivf_rerank_reference(st, qt, pt, 10, "cosine"), 3)
            print(f"timing: ivf_rerank B={B_time} P=2 k=10 plain version {plain_ms:.3f} ms")
            forms["int8+residual/query"] = {**rq, "max_abs_err": worst_err, "plain_ms": plain_ms}
            forms["int8+residual/cluster"] = {**rc, "max_abs_err": err_c, "plain_ms": plain_ms}
            forms["int8+residual/cluster"]["B1024_ms"] = rc1024["ms"]
            forms["int8+residual/query"]["B1024_ms"] = rq1024["ms"]
        else:
            rq1024, rc1024 = rq, rc

    # the forms without a residual, on the coarse values of the same state
    probes = synthetic_probes(torch, device, B, K, SEED + 10, P=4)
    pt = synthetic_probes(torch, device, B_time, K, SEED + 11, P=4)
    for name, dtype in (("int8", torch.int8), ("bf16", torch.bfloat16), ("f32", torch.float32)):
        s1 = one_slab(torch, st, dtype)
        err_t, agree_t, swaps_t = 0.0, 1.0, 0
        for metric, k in (("cosine", 10), ("l2", 10), ("sql2", 10), ("cosine", 128),
                          ("sql2", 128)):
            got = in_form(IC, "query", lambda: R.ivf_rerank(s1, q, probes, k, metric))
            want = R.ivf_rerank_reference(s1, q, probes, k, metric)
            agree, err, swaps, _ = hold(torch, got, want, slab_d64(torch, s1, q, metric))
            check(not bool(got[2][0].any()), "query 0 probes only invalid rows")
            err_t, agree_t, swaps_t = max(err_t, err), min(agree_t, agree), swaps_t + swaps
        ms = time_ms(torch, lambda: in_form(
            IC, "query", lambda: R.ivf_rerank(s1, qt, pt, 10, "cosine")), 20)
        plain_ms = time_ms(torch, lambda: R.ivf_rerank_reference(s1, qt, pt, 10, "cosine"), 2)
        (bound, by), blocks, stream = probe_bound(torch, s1, pt, B_time, 10, PEAK_F32)
        print(f"parity: ivf_rerank {name} slab (no residual), per-query form, P=4, 3 metrics at "
              f"k=10 and cosine/sql2 at k=128, B={B}: worst slot agreement {agree_t:.6f}, max "
              f"abs err {err_t:.3g}; {swaps_t} differing ranks, all ties (f64 gap <= {TIE_TOL})")
        print(f"timing: ivf_rerank {name} slab B={B_time} P=4 C=128 D={st.dim} k=10: per-query "
              f"form {ms:.3f} ms, plain {plain_ms:.3f} ms; bound {bound:.3f} ms by {by} ({blocks} "
              f"distinct blocks of {pt.numel()} probes, f32 rate); every query reading its own "
              f"live rows moves {stream / 1e9:.2f} GB, {stream / ms / 1e9:.2f} TB/s")
        forms[f"{name}/query"] = {"max_abs_err": err_t, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound, "bound_by": by}
        # the f32 form (3xTF32) over every probe width and k
        Ps, ks = ((4, 3, 2), (10, 40, 128)) if dtype == torch.float32 else ((4, 3), (10, 128))
        cases = cluster_cases(torch, device, B, K, SEED + 30, Ps)
        agree_c, err_c, swaps_c, n_c = cluster_form_parity(
            torch,
            lambda pr, k, m: in_form(IC, "cluster", lambda: R.ivf_rerank(s1, q, pr, k, m)),
            lambda pr, k, m: R.ivf_rerank_reference(s1, q, pr, k, m),
            lambda m: slab_d64(torch, s1, q, m), cases, ks)
        print(f"parity: ivf_rerank cluster-major form, {name} slab, P="
              f"{'/'.join(map(str, Ps))} and a hot cluster x 3 metrics x k="
              f"{'/'.join(map(str, ks))} ({n_c} cases), B={B}: worst slot agreement "
              f"{agree_c:.6f}, max abs err {err_c:.3g}; {swaps_c} differing ranks, all ties "
              f"(f64 gap <= {TIE_TOL})")
        for Bt, pb in ((B, probes), (B_time, pt)):
            rq, rc = cluster_timing(
                torch, IC, s1, qt[:Bt], pb, 10, "cosine",
                lambda f: in_form(IC, f, lambda: R.ivf_rerank(s1, qt[:Bt], pb, 10, "cosine")),
                False, False, PEAK_F32, f"ivf_rerank {name} slab (synthetic)")
        forms[f"{name}/cluster"] = {**rc, "max_abs_err": err_c, "plain_ms": plain_ms,
                                    "query_ms_in_turns": rq["ms"]}
        del s1
        torch.cuda.empty_cache()
    del st
    torch.cuda.empty_cache()
    return forms


def one_slab(torch, st, dtype):
    """``st`` as a state whose only slab is the coarse values in ``dtype``
    (int8 keeps scales; the wave re-rank never reads a residual)."""
    import dataclasses

    if dtype == torch.int8:
        return dataclasses.replace(st, residual=None, rscales=None)
    vec = torch.empty(st.vectors.shape, dtype=dtype, device=st.device)
    norms = torch.empty_like(st.norms)
    for s in range(0, vec.shape[0], 65536):
        x = (st.vectors[s : s + 65536].float() * st.scales[s : s + 65536, None]).to(dtype)
        vec[s : s + 65536] = x
        norms[s : s + 65536] = (x.float() ** 2).sum(-1)
    return dataclasses.replace(st, vectors=vec, norms=norms, scales=None, residual=None,
                               rscales=None)


def wave_kernel_parity(torch, V, TX, IC, device, B=1024, B_time=N_QUERIES):
    """Phase 7: kernel 2 vs its plain version on the synthetic state, every
    slab type, per-query form and cluster-major form, and both forms timed in
    turns on the int8 and f32 slabs at the refine path's shapes.
    Returns the records by "<slab form>/<kernel form>"."""
    full = synthetic_state(torch, V, device)
    K = full.num_clusters
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    q = torch.randn((B, full.dim), generator=g, device=device)
    recs = {}
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        name = str(dtype)[6:].replace("bfloat16", "bf16").replace("float32", "f32")
        st = one_slab(torch, full, dtype)
        agree_t, err_t, swaps_t = 1.0, 0.0, 0
        for P in (4, 3):
            probes = synthetic_probes(torch, device, B, K, SEED + 6, P=P)
            for metric in ("cosine", "l2", "sql2"):
                d64 = slab_d64(torch, st, TX._wave_query(st, q), metric)
                for k in (10, 40, 128):
                    got = in_form(IC, "query", lambda: TX.ivf_rerank_wave(st, q, probes, k, metric))
                    want = TX.ivf_rerank_wave_reference(st, q, probes, k, metric)
                    agree, err, swaps, _ = hold(torch, got, want, d64)
                    check(not bool(got[2][0].any()), "query 0 probes only invalid rows")
                    agree_t, err_t, swaps_t = min(agree_t, agree), max(err_t, err), swaps_t + swaps
        print(f"parity: ivf_rerank_wave {name} slab, per-query form, P=4 and 3, 3 metrics x "
              f"k=10/40/128, B={B}: worst slot agreement {agree_t:.6f}, max abs err "
              f"{err_t:.3g}; {swaps_t} differing ranks, all ties (f64 gap <= {TIE_TOL})")
        recs[f"{name}/query"] = {"max_abs_err": err_t}
        cases = cluster_cases(torch, device, B, K, SEED + 40, (4, 3, 2))
        agree_c, err_c, swaps_c, n_c = cluster_form_parity(
            torch, lambda pr, k, m: in_form(
                IC, "cluster", lambda: TX.ivf_rerank_wave(st, q, pr, k, m)),
            lambda pr, k, m: TX.ivf_rerank_wave_reference(st, q, pr, k, m),
            lambda m: slab_d64(torch, st, TX._wave_query(st, q), m), cases, (10, 40, 128))
        print(f"parity: ivf_rerank_wave cluster-major form, {name} slab, P=4/3/2 and a hot "
              f"cluster x 3 metrics x k=10/40/128 ({n_c} cases), B={B}: worst slot "
              f"agreement {agree_c:.6f}, max abs err {err_c:.3g}; {swaps_c} differing "
              f"ranks, all ties (f64 gap <= {TIE_TOL})")
        recs[f"{name}/cluster"] = {"max_abs_err": err_c}
        if dtype != torch.int8:
            del st
            torch.cuda.empty_cache()
    # both forms in turns on the int8 slab (the refine path's) and the f32
    # slab (whose route shares kernel 1's f32 threshold)
    qt = torch.randn((B_time, full.dim), generator=g, device=device)
    for name, dtype, peak in (("int8", torch.int8, PEAK_BF16), ("f32", torch.float32, PEAK_F32)):
        st = one_slab(torch, full, dtype)
        for Bt in (B, B_time):
            pt = synthetic_probes(torch, device, Bt, K, SEED + 7, P=4)
            qc = qt[:Bt]
            rq, rc = cluster_timing(
                torch, IC, st, qc, pt, 40, "cosine",
                lambda f: in_form(IC, f, lambda: TX.ivf_rerank_wave(st, qc, pt, 40, "cosine")),
                dtype != torch.float32, False, peak, f"ivf_rerank_wave {name} (synthetic state)")
            if Bt == B:
                b1024 = {"B1024_ms": rq["ms"]}, {"B1024_ms": rc["ms"]}
        plain_ms = time_ms(torch, lambda: TX.ivf_rerank_wave_reference(st, qt, pt, 40, "cosine"),
                           2)
        print(f"timing: ivf_rerank_wave B={B_time} P=4 k=40 {name} plain version "
              f"{plain_ms:.3f} ms")
        recs[f"{name}/query"].update({**rq, **b1024[0], "plain_ms": plain_ms})
        recs[f"{name}/cluster"].update({**rc, **b1024[1], "plain_ms": plain_ms})
        del st
        torch.cuda.empty_cache()
    del full
    torch.cuda.empty_cache()
    return recs


def insert_stages(db, tag, quant_before):
    """The insert's stage table (the facade's timers in ``db.stats``, the
    index's in the global collector, reset before the insert) and which host
    quantiser ran. The card's machine has ``g++``: the native quantiser must
    load, and the q8 tier must have quantised every span with it."""
    from zebra_tpu_torch import profiling as P
    from zebra_tpu_torch.index import ivf as V
    from zebra_tpu_torch.native import quant as NQ

    rows = [f"{name} {st['calls']}x {st['seconds']:.3f} s"
            for src in (db.stats, P.GLOBAL_STATS) for name, st in src.summary().items()
            if name.startswith(("insert", "ivf.", "rebuild."))]
    print(f"{tag}insert stages (host clock): {', '.join(rows)}")
    ran = {k: V.QUANT_CALLS[k] - quant_before[k] for k in V.QUANT_CALLS}
    check(NQ.available(), "the native quantiser did not build or load")
    print(f"{tag}host quantiser: native kernel built with g++ {' '.join(NQ.BUILT_WITH)}; "
          f"calls this insert: native {ran['native']}, numpy {ran['numpy']}")
    if db.index._wal_codec == "q8":
        check(ran["native"] > 0 and ran["numpy"] == 0,
              "the q8 tier must quantise every span with the native kernel")


def stream_vs_query(torch, db, batches, want, tag, label):
    """``db.query_stream`` over ``batches`` held batch for batch to
    ``db.query``'s answers ``want`` (one list per batch; equal, ids and
    distances); returns its QPS (host clock, results formatted)."""
    t0 = time.perf_counter()
    got = list(db.query_stream(batches, 10))
    qps = sum(len(b) for b in batches) / (time.perf_counter() - t0)
    same = sum(g == w for g, w in zip(got, want))
    print(f"{tag}query_stream {label}: {qps:.0f} QPS; {same} of {len(batches)} batches equal "
          f"db.query's")
    check(len(got) == len(want) and same == len(want),
          f"query_stream differs from db.query ({label})")
    return qps


def submit_timeline(torch, idx, big, tag):
    """One submit of the held-out batch: PyTorch's sync debug mode raises on
    any host sync inside it (IVF: none), the host clock at its return beside
    the device's time for the work it queued (CUDA events), whether the card
    was still busy when it returned, and the collect's wait. Then the host
    side of a batch alone: the pinned upload of its f32 rows by CUDA events
    beside a pageable one, filling the pinned buffer, and formatting the
    results."""
    import numpy as np

    ivf = hasattr(idx, "_spare_used")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    if ivf:
        torch.cuda.set_sync_debug_mode("error")
    try:
        tok = idx.search_submit(big, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.record()
    submit_ms = (time.perf_counter() - t0) * 1e3
    busy = not end.query()
    res = idx.search_collect(tok)
    collect_ms = (time.perf_counter() - t0) * 1e3
    device_ms = start.elapsed_time(end)
    print(f"{tag}submit timeline, B={len(big)}: submit returned after {submit_ms:.3f} ms "
          f"(host clock{', no host sync under sync debug mode' if ivf else ''}) with the card "
          f"{'still busy' if busy else 'idle'}; the work it queued took {device_ms:.3f} ms on "
          f"the card; collect returned at {collect_ms:.3f} ms")
    if ivf:
        check(busy, "an IVF submit of 16384 queries returned after the card finished")
    q = np.ascontiguousarray(big, dtype=np.float32)
    pinned = torch.empty(q.shape, dtype=torch.float32, pin_memory=True)
    fill_ms = time_ms_host(lambda: pinned.copy_(torch.from_numpy(q)), 5)
    dev = torch.empty(q.shape, dtype=torch.float32, device=idx.device)
    up_ms = time_ms(torch, lambda: dev.copy_(pinned, non_blocking=True), 10)
    page_ms = time_ms_host(lambda: torch.from_numpy(q).to(idx.device), 5, torch)
    fmt_ms = time_ms_host(lambda: idx._format_results(*res), 3)
    print(f"{tag}host side of a batch of {len(big)} ({q.nbytes / 1e6:.1f} MB of f32 rows): "
          f"filling the pinned buffer {fill_ms:.3f} ms (host clock), pinned upload "
          f"{up_ms:.3f} ms (CUDA events), pageable upload {page_ms:.3f} ms (host clock, "
          f"synchronised), _format_results {fmt_ms:.3f} ms (host clock)")
    return {"submit_ms": submit_ms, "device_ms": device_ms, "collect_ms": collect_ms,
            "fill_ms": fill_ms, "upload_ms": up_ms, "pageable_ms": page_ms, "format_ms": fmt_ms}


def mutate_and_dedup(torch, db, ids, base, tag):
    """A submit / mutate / collect check, then deduplicate. A batch of
    inserted rows is submitted; before it is collected, 1000 exact copies of
    other base rows are inserted and 10 of the batch's own rows removed.
    The collect must equal the answer taken before the submit, bitwise; the
    removed rows must be gone from the next answer. Then ``deduplicate``
    must remove exactly the 1000 copies (their ids are the later ones)."""
    import numpy as np

    idx = db.index
    q = base[MUTATE_QUERY_ROWS]
    want = idx.search_arrays(q, 10)
    tok = idx.search_submit(q, 10)
    dup_ids = db.insert_vectors(base[DUP_ROWS])
    gone = ids[MUTATE_REMOVE_ROWS]
    db.remove(gone)
    got = idx.search_collect(tok)
    same = (np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
            and np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32)))
    after = {i for row in db.query(q[:10], 10) for i, _ in row}
    print(f"{tag}submit / mutate / collect: {len(dup_ids)} rows inserted and {len(gone)} of "
          f"the batch's rows removed between submit and collect; collect equals the answer "
          f"before the submit: {same}; removed rows in the next answer: {len(after & set(gone))}")
    check(same and not after & set(gone), "collect did not return the pre-mutation answer")
    n = len(db)
    t0 = time.perf_counter()
    db.deduplicate()
    dedup_s = time.perf_counter() - t0
    removed = n - len(db)
    left = sum(i in idx for i in dup_ids)
    print(f"{tag}deduplicate: {removed} ids removed of {len(dup_ids)} planted copies ({left} "
          f"left) in {dedup_s:.3f} s (host clock, {n} live rows)")
    check(removed == len(dup_ids) and left == 0
          and all(i in idx for i in ids[DUP_ROWS]), "deduplicate did not remove exactly the copies")
    return dedup_s


def main_path(torch, zt, V, tmp, base, queries, cfg, tag, counter):
    """Phases 4 and 8: an IVF configuration through the facade. ``counter``
    is the ``(module, attribute)`` of the launch count of the kernel the
    configuration resolves to: set to 0 here, read at the end, as is its
    count by slab form where the module keeps one (``<attribute>_BY_FORM``).
    Returns that count, the open database, the inserted ids, the base-row
    numbers of the top-10 of the first 1024 held-out queries (after the
    removes), the count by form ({} where there is none) and the pipelined
    surface's record (stage table, stream QPS, submit timeline, dedup)."""
    import numpy as np
    from zebra_tpu_torch import profiling as P
    from zebra_tpu_torch.utils import device_sync

    (n, dim), n_queries = base.shape, queries.shape[0]
    path = os.path.join(tmp, "smoke.zebra")
    setattr(*counter, 0)
    by_form = getattr(counter[0], counter[1] + "_BY_FORM", {})
    by_form.clear()
    V.EAGER_LARGE_K = 0
    P.GLOBAL_STATS.ops.clear()
    quant_before = dict(V.QUANT_CALLS)
    t0 = time.perf_counter()
    db = zt.Database.create(path, cfg)
    ids = db.insert_vectors(base)
    device_sync()
    build_s = time.perf_counter() - t0
    st = db.index.stats()
    print(f"{tag}insert: {n} x {dim} in {build_s:.2f} s = {n / build_s:.0f} rows/s "
          f"(durability={db.config.durability}, rerank={db.index.options.rerank}, "
          f"slab={str(db.index.state.vectors.dtype)[6:]}, wal={db.index._wal_codec}, "
          f"wire={db.index._wire_row_bytes} B/row, "
          f"refine={db.index.options.refine}, probes={db.index.options.resolved_probes()}, "
          f"clusters={st['clusters']}, C={st['cluster_capacity']}, "
          f"spare={st['spare_capacity']}, spare_used={st['spare_used']}, "
          f"max load={st['max_cluster_load']}, overflow={st['overflow']})")
    check(len(db) == n and st["overflow"] == 0, "rows lost on insert")
    insert_stages(db, tag, quant_before)
    rec = {"insert_s": build_s, "stages": db.stats.summary() | P.GLOBAL_STATS.summary(),
           "settle_s": [settle(db, tag, "after the insert")]}

    before = getattr(*counter)
    t0 = time.perf_counter()
    results = []
    for s in range(0, n_queries, 1024):
        results += db.query(queries[s : s + 1024], 10)
    qs = time.perf_counter() - t0
    print(f"{tag}query: {n_queries} queries via db.query in batches of 1024: "
          f"{n_queries / qs:.0f} QPS (facade, results formatted)")
    check(getattr(*counter) > before, "db.query did not launch the kernel")
    check(all(len(r) == 10 and all(np.isfinite(d) for _, d in r) for r in results),
          "every query must return 10 finite results")
    rec["query_qps_1024"] = n_queries / qs
    rec["stream_qps_1024"] = stream_vs_query(
        torch, db, [queries[s : s + 1024] for s in range(0, n_queries, 1024)],
        [results[s : s + 1024] for s in range(0, n_queries, 1024)], tag,
        f"in batches of 1024 over the {n_queries} held-out queries (db.query: {n_queries / qs:.0f} QPS)")

    qt = torch.from_numpy(queries[:1024]).to(db.index.device)
    _, approx, _ = db.index.search_arrays(queries[:1024], 10)
    _, exact, _ = V.brute_force(db.index.state, qt, 10, metric=db.index.metric)
    exact = exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))
    stored = ("int8 + residual reconstruction" if db.index.state.residual is not None
              else f"{str(db.index.state.vectors.dtype)[6:]} rows")
    print(f"{tag}recall@10: {recall:.4f} over 1024 held-out queries (vs the exact scan "
          f"of the stored {stored})")
    check(recall >= MIN_RECALL, f"recall@10 {recall} < {MIN_RECALL}")
    if db.index.options.query_wire_is_bf16():
        # the index searched the queries rounded to bf16: split that rounding
        # from the probe loss with an oracle that sees the same queries
        _, wire, _ = V.brute_force(db.index.state, qt.to(torch.bfloat16).float(), 10,
                                   metric=db.index.metric)
        wire = wire.cpu().numpy()

        def overlap(found, truth):
            return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(found, truth)]))

        print(f"{tag}recall@10 against the exact scan of the queries as the bf16 query wire "
              f"ships them: {overlap(approx, wire):.4f}; the two exact scans agree on "
              f"{overlap(exact, wire):.4f}")

    pick = np.linspace(0, n - 1, 256).astype(np.int64)
    hits = db.query(base[pick], 1)
    self_rate = float(np.mean([h[0][0] == ids[i] for h, i in zip(hits, pick)]))
    print(f"{tag}self-retrieval: {self_rate:.4f} over 256 inserted rows")
    check(self_rate == 1.0, "an inserted row did not retrieve itself")

    gone = ids[1000:1100]
    db.remove(gone)
    back = {i for row in db.query(base[1000:1100], 10) for i, _ in row} & set(gone)
    print(f"{tag}remove: 100 ids removed, {len(back)} came back")
    check(not back and len(db) == n - 100, "a removed id came back")
    rec["dedup_s"] = mutate_and_dedup(torch, db, ids, base, tag)

    probe_q = queries[:1024]
    want = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    rec["settle_s"].append(settle(db, tag, "before the save"))
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    del db
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = zt.Database.open(path)
    open_s = time.perf_counter() - t0
    got = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    print(f"{tag}save {save_s:.2f} s, open {open_s:.2f} s: same top-10 ids after reopen: "
          f"{got == want}")
    check(got == want and len(db) == n - 110, "reopened database answers differently")
    check(db.config.index.rerank == cfg.index.rerank, "the manifest changed the stored rerank")
    row_of = {i: r for r, i in enumerate(ids)}
    approx_rows = np.array([[row_of[i] for i in row] for row in got])

    big = queries[:n_queries]
    db.index.search_arrays(big, 10)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        db.index.search_arrays(big, 10)  # returns host arrays: synchronised
    dev_qps = 3 * n_queries / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    big_rows = db.query(big, 10)
    facade_qps = n_queries / (time.perf_counter() - t0)
    print(f"{tag}query: batch {n_queries}: {dev_qps:.0f} QPS (index.search_arrays, "
          f"device synchronised), {facade_qps:.0f} QPS (db.query, results formatted)")
    stream = [big] * STREAM_REPEATS
    t0 = time.perf_counter()
    for got_rows in db.index.search_stream(stream, 10):
        pass
    search_stream_qps = STREAM_REPEATS * n_queries / (time.perf_counter() - t0)
    check(got_rows == big_rows, "search_stream differs from db.query at batch 16384")
    rec.update(search_arrays_qps=dev_qps, query_qps=facade_qps, search_stream_qps=search_stream_qps,
               stream_qps=stream_vs_query(
                   torch, db, stream, [big_rows] * STREAM_REPEATS, tag,
                   f"at batch {n_queries}, {STREAM_REPEATS} batches (index.search_stream: "
                   f"{search_stream_qps:.0f} QPS, results formatted; index.search_arrays "
                   f"{dev_qps:.0f}; db.query {facade_qps:.0f})"),
               timeline=submit_timeline(torch, db.index, big, tag))
    launches, launches_by_form = getattr(*counter), dict(by_form)
    print(f"{tag}launches: {counter[1]} {launches} over the path "
          f"{launches_by_form or ''}; eager large-k fallbacks {V.EAGER_LARGE_K}")
    check(launches > 0 and V.EAGER_LARGE_K == 0, "the path must run through its kernel")
    check(not launches_by_form or sum(launches_by_form.values()) == launches,
          "the launches by form must add up to the launches")
    return launches, db, ids, approx_rows, launches_by_form, rec


def probe_selection_report(torch, V, st, qt, P, metric, tag, crowded=False):
    """Probe selection's stage 1 on the tensor cores (one bf16 GEMM with an
    f32 accumulator) against its plain version (the bf16 operands multiplied
    in f32 on the CUDA cores), both followed by the same f32 stage 2: the
    two timed in turns (new, plain, plain, new), the share of the B*P probes
    they agree on (held to MIN_PROBE_AGREEMENT) and each one's agreement
    with the exact f32 probes (printed). ``crowded`` (the audio databases,
    whose embeddings crowd together): below MIN_PROBE_AGREEMENT, every cell
    that one stage 1 keeps and the other drops must instead score, exactly
    on the bf16-rounded operands (``stage1_scores``), within TIE_TOL of the
    2P-th best. Returns the new selection's ms."""
    def sel(emulate):
        cand = V.probe_candidates(st, qt, 2 * P, metric, emulate=emulate)
        return V.rescore_probes(st, qt, cand, P, metric)

    t = [time_ms(torch, lambda: sel(e), 10) for e in (False, True, True, False)]
    new, plain = sel(False), sel(True)
    exact = V.select_probes(st, qt, P, metric, probe_sel="f32")

    def agree(a, b):
        return float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())

    a_plain, a_new, a_old = agree(new, plain), agree(new, exact), agree(plain, exact)
    ties = ""
    if crowded and a_plain < MIN_PROBE_AGREEMENT:
        n_diff, gap = stage1_ties(torch, V, st, qt, P, metric)
        ties = (f"; audio (crowded), below {MIN_PROBE_AGREEMENT}: the stage-1 candidate sets of "
                f"{n_diff} queries differ, every differing cell scored in f64 within {gap:.3g} "
                f"(<= {TIE_TOL}) of the 2P-th best: f32 summation-order ties")
        check(gap <= TIE_TOL, f"stage 1 on the tensor cores picks cells {gap} from its plain "
              f"version's (> {TIE_TOL}): not a tie")
    print(f"{tag}probe selection, B={qt.shape[0]} P={P}, in turns tensor-core/plain/plain/"
          f"tensor-core {'/'.join(f'{x:.3f}' for x in t)} ms; the two agree on {a_plain:.6f} of "
          f"the B*P probes; agreement with the exact f32 probes: tensor-core {a_new:.6f}, "
          f"plain {a_old:.6f}{ties}")
    check(a_plain >= MIN_PROBE_AGREEMENT or crowded,
          f"stage 1 on the tensor cores agrees with its plain version on {a_plain} < "
          f"{MIN_PROBE_AGREEMENT} of the probes")
    return (t[0] + t[3]) / 2


def stage1_scores(torch, st, q, metric):
    """Stage 1 of probe selection (``ivf.probe_candidates``; the reference's
    ``zebra_tpu/index/ivf.py:514-523``) recomputed exactly for queries
    ``q [B, D]``: every centroid's score from the bf16-rounded query and
    centroids, multiplied and summed in f64 (stage 1's products are exact;
    only its f32 sum rounds), with the |c|^2 of the f32 centroids. ``[B, K]``
    f64, higher is nearer."""
    qb = q.to(torch.bfloat16).double()
    c64 = st.centroids.double()
    cn2 = (c64 * c64).sum(-1)
    dot = qb @ st.centroids.to(torch.bfloat16).double().T
    return dot / cn2.sqrt().clamp(min=1e-30) if metric == "cosine" else 2.0 * dot - cn2


def stage1_ties(torch, V, st, qt, P, metric):
    """Where stage 1 on the tensor cores and its plain version keep
    different 2P cells (the same products, summed in another order), the
    ``stage1_scores`` of every cell in one set and not the other against
    the 2P-th best: ``(queries whose sets differ, the largest gap relative
    to 1 + |score|)``."""
    a = V.probe_candidates(st, qt, 2 * P, metric, emulate=False)
    b = V.probe_candidates(st, qt, 2 * P, metric, emulate=True)
    a_in_b = (a[:, :, None] == b[:, None, :]).any(-1)
    b_in_a = (b[:, :, None] == a[:, None, :]).any(-1)
    rows = torch.nonzero(~a_in_b.all(1) | ~b_in_a.all(1)).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    s = stage1_scores(torch, st, qt[rows], metric)
    kth = s.topk(2 * P, dim=1).values[:, -1:]
    cells = torch.cat([torch.where(a_in_b[rows], -1, a[rows]),
                       torch.where(b_in_a[rows], -1, b[rows])], 1)
    gaps = ((s.gather(1, cells.clamp(min=0)) - kth).abs() / (1.0 + kth.abs()))[cells >= 0]
    return int(rows.numel()), float(gaps.max())


def probe_path_stages(torch, V, R, IC, db, queries, scan_residual, tag, crowded=False):
    """Phases 4, 10 and 11, after the facade run (these launches come after the
    count was read): kernel 1's form of the tier on the path's own probes,
    both kernel forms against the plain version and timed in turns, probe
    selection new against plain (``crowded``: see ``probe_selection_report``),
    and the stages of one device query by CUDA events, at B=1024 and
    B=16384. Returns the records of the two forms at B=16384."""
    idx = db.index
    st, metric, P = idx.state, idx.metric, idx.options.resolved_probes()
    name = R._FORM_NAME[st.vectors.dtype] + (
        "+residual" if scan_residual and st.residual is not None else "")
    recs = {}
    for B in (1024, queries.shape[0]):
        qt = torch.from_numpy(queries[:B]).to(idx.device)
        probes = V.select_probes(st, qt, P, metric, idx.options.probe_sel)
        want = R.ivf_rerank_reference(st, qt, probes, 10, metric, scan_residual=scan_residual)
        d64 = slab_d64(torch, st, qt, metric, residual=scan_residual)
        for form in ("query", "cluster"):
            # clustered data: every differing rank must be a tie
            got = in_form(IC, form, lambda: R.ivf_rerank(st, qt, probes, 10, metric, scan_residual))
            agree, err, swaps, gap = hold(torch, got, want, d64, min_agree=0.0)
            print(f"{tag}parity: ivf_rerank {name} {form} form on the path's probes, B={B} P={P} "
                  f"k=10: slot agreement {agree:.6f}, max abs err {err:.3g}, valid results "
                  f"{int(got[2].sum())}; {swaps} differing ranks, all ties (largest f64 gap "
                  f"{gap:.3g} <= {TIE_TOL})")
            recs.setdefault(f"{name}/{form}", {})["max_abs_err"] = max(
                err, recs.get(f"{name}/{form}", {}).get("max_abs_err", 0.0))
            del got
        rq, rc = cluster_timing(
            torch, IC, st, qt, probes, 10, metric,
            lambda f: in_form(IC, f, lambda: R.ivf_rerank(st, qt, probes, 10, metric,
                                                          scan_residual)), False,
            scan_residual and st.residual is not None, PEAK_F32, f"{tag}ivf_rerank {name} (path)")
        plain_ms = time_ms(torch, lambda: R.ivf_rerank_reference(
            st, qt, probes, 10, metric, scan_residual=scan_residual), 2)
        kernel_ms = time_ms(torch, lambda: R.ivf_rerank(st, qt, probes, 10, metric,
                                                        scan_residual), 20)
        sel_ms = probe_selection_report(torch, V, st, qt, P, metric, tag, crowded)
        spare = "spare empty, _merge_spare not run"
        if idx._spare_used > 0:
            got = R.ivf_rerank(st, qt, probes, 10, metric, scan_residual)
            sp = time_ms(torch, lambda: V._merge_spare(st, qt, *got, 10, metric,
                                                       scan_residual), 5)
            spare = f"_merge_spare {sp:.3f} ms"
        whole_ms = time_ms(torch, lambda: idx._query_device(qt, 10, exact=False), 10)
        route = "cluster" if IC.takes_cluster_form(B, P, st.dim, st.cluster_capacity,
                                                   st.vectors.dtype, 10) else "query"
        print(f"{tag}stages, B={B}, one device query {whole_ms:.3f} ms: select_probes "
              f"{sel_ms:.3f} ms, ivf_rerank {kernel_ms:.3f} ms ({route} form by the route; plain "
              f"{plain_ms:.3f} ms), {spare}; distinct probed blocks "
              f"{int(torch.unique(probes).numel())} of B*P = {B * P}")
        if B == queries.shape[0]:
            recs[f"{name}/query"].update({**rq, "plain_ms": plain_ms})
            recs[f"{name}/cluster"].update({**rc, "plain_ms": plain_ms})
        del probes, want
    return recs


def refine_path_stages(torch, V, TX, IC, db, ids, queries, scan_rows):
    """Phase 8, after the facade run (these launches come after the count
    was read): kernel 2 on the path's own probes, both forms against the
    plain version and timed in turns, probe selection new against plain, the
    stages of one device query by CUDA events, the distinct probed blocks,
    and both tiers' recall against this database's exact scan."""
    import numpy as np

    idx = db.index
    st, metric = idx.state, idx.metric
    P, kk = idx.options.resolved_probes(), idx.options.refine_k(10)
    check((P, kk) == (4, 40), f"refine=4 must resolve to P=4, kk=40, got {(P, kk)}")
    recs = {}
    for B in (1024, queries.shape[0]):
        qt = torch.from_numpy(queries[:B]).to(idx.device)
        probes = V.select_probes(st, qt, P, metric, idx.options.probe_sel)
        want = TX.ivf_rerank_wave_reference(st, qt, probes, kk, metric)
        d64 = slab_d64(torch, st, TX._wave_query(st, qt), metric)
        for form in ("query", "cluster"):
            # clustered data: near-equal distances swap by f32 summation order,
            # so every differing rank is held to a tie (as phase 6 does)
            got = in_form(IC, form, lambda: TX.ivf_rerank_wave(st, qt, probes, kk, metric))
            agree, err, swaps, gap = hold(torch, got, want, d64, min_agree=0.0)
            print(f"refine parity: ivf_rerank_wave {form} form on the path's probes, B={B} "
                  f"P={P} k={kk}: slot agreement {agree:.6f}, max abs err {err:.3g}, valid "
                  f"results {int(got[2].sum())}; {swaps} differing ranks, all ties (largest "
                  f"f64 gap {gap:.3g} <= {TIE_TOL})")
            recs.setdefault(f"int8/{form}", {})["max_abs_err"] = max(
                err, recs.get(f"int8/{form}", {}).get("max_abs_err", 0.0))
        rq, rc = cluster_timing(
            torch, IC, st, qt, probes, kk, metric,
            lambda f: in_form(IC, f, lambda: TX.ivf_rerank_wave(st, qt, probes, kk, metric)), True,
            False,
            PEAK_BF16, "refine ivf_rerank_wave int8 (path)")
        plain_ms = time_ms(
            torch, lambda: TX.ivf_rerank_wave_reference(st, qt, probes, kk, metric), 2)
        kernel_ms = time_ms(torch, lambda: TX.ivf_rerank_wave(st, qt, probes, kk, metric), 20)
        sel_ms = probe_selection_report(torch, V, st, qt, P, metric, "refine ")
        ref_ms = time_ms(torch, lambda: V._refine_topk(st, qt, *got, 10, metric), 10)
        spare = "spare empty, _merge_spare not run"
        if idx._spare_used > 0:
            sp = time_ms(torch, lambda: V._merge_spare(st, qt, *got, kk, metric, False), 5)
            spare = f"_merge_spare {sp:.3f} ms"
        whole_ms = time_ms(torch, lambda: idx._query_device(qt, 10, exact=False), 10)
        route = "cluster" if IC.takes_cluster_form(B, P, st.dim, st.cluster_capacity,
                                                   st.vectors.dtype, kk, round_q=True) else "query"
        print(f"refine stages, B={B}, one device query {whole_ms:.3f} ms: select_probes "
              f"{sel_ms:.3f} ms, ivf_rerank_wave {kernel_ms:.3f} ms ({route} form by the route; "
              f"plain {plain_ms:.3f} ms), {spare}, _refine_topk {ref_ms:.3f} ms; distinct probed "
              f"blocks {int(torch.unique(probes).numel())} of B*P = {B * P}")
        if B == queries.shape[0]:
            recs["int8/query"].update({**rq, "plain_ms": plain_ms})
            recs["int8/cluster"].update({**rc, "plain_ms": plain_ms})
        del got, want, probes

    # both tiers against ONE oracle: this database's exact scan, by base row
    qt = torch.from_numpy(queries[:1024]).to(idx.device)
    row_of = {i: r for r, i in enumerate(ids)}

    def rows(slots):
        return [[row_of.get(i, -1) for i in idx._slot_ids.take_list(row)] for row in slots]

    _, exact, _ = V.brute_force(st, qt, 10, metric=metric)
    exact = rows(exact.cpu().numpy())
    _, approx, _ = idx.search_arrays(queries[:1024], 10)

    def recall(found):
        return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(found, exact)]))

    print(f"recall@10 of the same 1024 held-out queries against this phase's exact scan "
          f"(100 rows removed in both): refine=4 P=4 {recall(rows(approx)):.4f}; "
          f"refine='scan' P=2 (phase 4's answers) {recall(scan_rows.tolist()):.4f}")
    return recs


def lsh_candidates(torch, device, S, B, M, seed):
    """Synthetic LSH candidates ``(cand int32, valid f32)`` ``[B, M]``.
    M=3000 has the shape of an uncompacted probe set: sorted random slots
    with -1 pads and masked duplicates (~90% valid). Wider sets have the
    compacted shape: 1..8192 valid slots first (a masked duplicate among
    them), -1 after. Query 0 has nothing valid; query 1 holds slot 7."""
    g = torch.Generator(device=device).manual_seed(seed)
    cand = torch.randint(0, S, (B, M), generator=g, device=device, dtype=torch.int32)
    col = torch.arange(M, device=device)
    if M <= 4096:
        cand[:, ::11] = -1
        cand[:, 1::13] = cand[:, 2::13][:, : cand[:, 1::13].shape[1]]  # duplicates
        cand = torch.sort(cand, dim=1).values
        valid = cand >= 0
        valid[:, 1:] &= cand[:, 1:] != cand[:, :-1]
    else:
        live = torch.randint(1, 8193, (B, 1), generator=g, device=device)
        cand[:, 1] = cand[:, 0]
        valid = col[None, :] < live
        valid[:, 1] = False
        cand = torch.where(valid | (col[None, :] == 1), cand, torch.full_like(cand, -1))
    cand[1, 0], valid[1, 0] = 7, True
    valid[0] = False
    return cand.contiguous(), valid.float().contiguous()


def lsh_dense_candidates(torch, device, slab, B, occupied, share, seed):
    """Sorted dense LSH candidates in the compacted layout: each query holds
    ~``share`` of the slab's first ``occupied`` rows, ascending, then -1 pads
    to a common width (a multiple of 1024). Query 0 has nothing valid; query
    1 holds slot 7 (a zero row); in every other row the third entry is dead
    (masked) and the sixth is a masked copy of the seventh. Returns ``(cand
    int32, norms f32, valid f32)`` ``[B, M]``."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows, width = [], 0
    for s in range(0, B, 128):
        hold = torch.rand((min(128, B - s), occupied), generator=g, device=device) < share
        if s == 0:
            hold[1, 7] = True
        rank = torch.cumsum(hold, dim=1) - 1
        n = int(rank[:, -1].max()) + 1
        out = torch.full((hold.shape[0], n + 1), -1, dtype=torch.int32, device=device)
        col = torch.arange(occupied, dtype=torch.int32, device=device).expand_as(hold)
        out.scatter_(1, torch.where(hold, rank, torch.full_like(rank, n)),
                     torch.where(hold, col, torch.full_like(col, -1)))
        rows.append(out[:, :n])
        width = max(width, n)
        del hold, rank, col, out
    M = -(-width // 1024) * 1024
    cand = torch.full((B, M), -1, dtype=torch.int32, device=device)
    for i, r in enumerate(rows):
        cand[128 * i : 128 * i + r.shape[0], : r.shape[1]] = r
    del rows
    valid = cand >= 0
    valid[2:, 2] = False  # a dead row
    cand[2:, 5] = cand[2:, 6]  # a masked duplicate before its valid twin
    valid[2:, 5] = False
    valid[0] = False
    norms = (slab.float() ** 2).sum(-1)[torch.clamp(cand, 0, slab.shape[0] - 1).long()]
    return cand.contiguous(), norms.contiguous(), valid.float().contiguous()


def lsh_dense_parity(torch, LR, device, slab, q, B=1024):
    """Phase 5, the slab-major form: against the plain version on the sorted
    dense case (f32 slab, then its bf16 copy), and both forms timed on it."""
    cand, norms32, valid = lsh_dense_candidates(torch, device, slab, B, DENSE_OCCUPIED,
                                                DENSE_SHARE, SEED + 9)
    slab_kw = dict(sorted_slots=True, occupied=DENSE_OCCUPIED)
    worst_err = 0.0
    for dtype, cases in ((torch.float32, (("cosine", 10), ("l2", 10), ("sql2", 10),
                                          ("cosine", 128))),
                         (torch.bfloat16, (("cosine", 10), ("sql2", 128)))):
        name = str(dtype)[6:]
        vec = slab if dtype == torch.float32 else slab.to(dtype)
        norms = norms32 if dtype == torch.float32 else (
            (vec.float() ** 2).sum(-1)[torch.clamp(cand, 0, vec.shape[0] - 1).long()])
        args = (vec, q[:B], cand, norms, valid)
        check(LR.takes_slab_form(True, dtype, 10, cand.shape[1], DENSE_OCCUPIED),
              "the dense case must take the slab-major form")
        slab0 = LR.LAUNCHES_SLAB
        for metric, k in cases:
            gd, gp = LR.lsh_rerank(*args, metric=metric, k=k, **slab_kw)
            wd, wp = LR.lsh_rerank_reference(*args, metric=metric, k=k)
            agree, err = compare(torch, (gd, gp, gp >= 0), (wd, wp, wp >= 0))
            swaps, gap = tie_gap(torch, gp, wp, lsh_d64(torch, vec, q[:B], cand, norms, metric))
            check(not bool((gp[0] >= 0).any()), "query 0 has no valid candidate")
            print(f"parity: lsh_rerank slab form, sorted dense M={cand.shape[1]} {name} slab "
                  f"{metric} k={k} B={B}: position agreement {agree:.6f}, max abs err {err:.3g}; "
                  f"{swaps} differing ranks, all ties (largest f64 gap {gap:.3g} <= {TIE_TOL})")
            worst_err = max(worst_err, err)
        check(LR.LAUNCHES_SLAB == slab0 + len(cases),
              "the dense case did not launch the slab-major form")
        gather = time_ms(torch, lambda: LR.lsh_rerank(*args, k=10), 2)
        slab_ms = time_ms(torch, lambda: LR.lsh_rerank(*args, k=10, **slab_kw), 5)
        slab128 = time_ms(torch, lambda: LR.lsh_rerank(*args, k=128, **slab_kw), 3)
        n_valid = float(valid.sum())
        bound, by = bound_ms(
            cand.numel() * 4 + n_valid * 8 + DENSE_OCCUPIED * vec.shape[1] * vec.element_size()
            + B * (q.shape[1] * 4 + 80), n_valid * 2 * q.shape[1], PEAK_F32)
        print(f"timing: lsh_rerank sorted dense B={B} M={cand.shape[1]} "
              f"({n_valid / B:.0f} valid per query of {DENSE_OCCUPIED} occupied rows) {name} "
              f"k=10: slab form {slab_ms:.3f} ms (k=128: {slab128:.3f} ms), gather form "
              f"{gather:.3f} ms; bound {bound:.3f} ms by {by} (f32 rate)")
        del vec, norms, args
    return worst_err


def lsh_kernel_parity(torch, LR, device, S=2 * 1024 * 1024, D=DIM, B=1024, B_time=N_QUERIES):
    """Phase 5: kernel 4 against its plain version on a slab of the main
    path's size (2M x 768; slot 7 a zero row), at both candidate widths."""
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    slab = torch.randn((S, D), generator=g, device=device)
    slab[7] = 0.0
    q = torch.randn((B_time, D), generator=g, device=device)
    worst_agree, worst_err, times = 1.0, 0.0, {}
    slab_launches = LR.LAUNCHES_SLAB
    for M in (3000, 65536):
        cand, valid = lsh_candidates(torch, device, S, B_time, M, SEED + M)
        idx = torch.clamp(cand, 0, S - 1).long()
        for dtype in (torch.float32, torch.bfloat16):
            vec = slab if dtype == torch.float32 else slab.to(dtype)
            norms = (vec.float() ** 2).sum(-1)[idx]
            args = (vec, q[:B], cand[:B], norms[:B].contiguous(), valid[:B])
            for metric in ("cosine", "l2", "sql2"):
                for k in (10, 128):
                    gd, gp = LR.lsh_rerank(*args, metric=metric, k=k)
                    wd, wp = LR.lsh_rerank_reference(*args, metric=metric, k=k)
                    agree, err = compare(torch, (gd, gp, gp >= 0), (wd, wp, wp >= 0))
                    check(agree >= MIN_SLOT_AGREEMENT,
                          f"position agreement {agree} < {MIN_SLOT_AGREEMENT}")
                    check(not bool((gp[0] >= 0).any()), "query 0 has no valid candidate")
                    worst_agree, worst_err = min(worst_agree, agree), max(worst_err, err)
            print(f"parity: lsh_rerank M={M} {str(dtype)[6:]} slab, 3 metrics x k=10/128, "
                  f"B={B}: worst position agreement {worst_agree:.6f}, "
                  f"max abs err {worst_err:.3g}")
            if dtype == torch.float32:
                full = (slab, q, cand, norms, valid)
                ms = time_ms(torch, lambda: LR.lsh_rerank(*full, k=10), 5 if M <= 4096 else 2)
                plain_ms = time_ms(torch, lambda: LR.lsh_rerank_reference(*full, k=10), 1)
                n_valid = float(valid.sum())
                bound = (B_time * M * 4 + n_valid * (8 + D * 4)) / HBM_BYTES_S * 1e3
                print(f"timing: lsh_rerank B={B_time} M={M} D={D} f32 k=10 "
                      f"({n_valid / B_time:.0f} valid candidates per query): kernel "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms; bytes bound at 3.35 TB/s "
                      f"{bound:.3f} ms")
                times[M] = (ms, plain_ms)
            del vec, norms, args
        del cand, valid, idx
    check(LR.LAUNCHES_SLAB == slab_launches,
          "the synthetic M=3000 / M=65,536 cases must take the gather form")
    torch.cuda.empty_cache()
    worst_err = max(worst_err, lsh_dense_parity(torch, LR, device, slab, q))
    del slab, q
    torch.cuda.empty_cache()
    return {"max_abs_err": worst_err, "times": times}


def lsh_path(torch, zt, TB, LR, tmp, base, queries):
    """Phase 6: the LSH library defaults through the facade. Returns the
    kernel launch count of the run and the slab-major form's share of it,
    and, on the path's own candidates of 1024 held-out queries, the kernel's
    max abs error against its plain version, both forms' times, the plain
    version's and the bound; under "pipeline", the pipelined surface's record
    (stage table, stream QPS, submit timeline, dedup)."""
    import numpy as np
    from zebra_tpu_torch import profiling as P
    from zebra_tpu_torch.index import ivf as V
    from zebra_tpu_torch.utils import device_sync

    (n, dim), n_queries = base.shape, queries.shape[0]
    path = os.path.join(tmp, "lsh.zebra")
    cfg = zt.DatabaseConfig(dim=dim, index=zt.IndexOptions(index_type="lsh"))
    LR.LAUNCHES = LR.LAUNCHES_SLAB = 0
    TB.EAGER_LARGE_K = 0
    P.GLOBAL_STATS.ops.clear()
    quant_before = dict(V.QUANT_CALLS)
    t0 = time.perf_counter()
    db = zt.Database.create(path, cfg)
    ids = db.insert_vectors(base)
    device_sync()
    build_s = time.perf_counter() - t0
    idx = db.index
    st = idx.stats()
    probes = idx.options.resolved_probes()
    full = st["tables"] * probes * st["bucket_capacity"]
    mc, lossless = idx._candidate_width(probes)
    width = "lossless compaction" if lossless else (mc or "all")
    print(f"lsh insert: {n} x {dim} in {build_s:.2f} s = {n / build_s:.0f} rows/s "
          f"(durability={db.config.durability}, rerank={idx.options.rerank}, "
          f"tables={st['tables']}, bits={st['bits']}, bucket capacity="
          f"{st['bucket_capacity']} (cap_boost {st['cap_boost']}), probes={probes}, "
          f"candidate width: {width} of T*P*C={full}, slab={st['slab_capacity']}, "
          f"overflow={st['overflow']})")
    check(len(db) == n and idx.options.rerank == "cuda", "LSH insert lost rows or rerank")
    insert_stages(db, "lsh ", quant_before)
    rec = {"insert_s": build_s, "stages": db.stats.summary() | P.GLOBAL_STATS.summary(),
           "settle_s": [settle(db, "lsh ", "after the insert")]}
    qt = torch.from_numpy(queries[:1024]).to(idx.device)
    t0 = time.perf_counter()
    cand, cand_valid = TB._candidates(idx.state, qt, probes, mc, lossless)
    device_sync()
    cand_s = time.perf_counter() - t0
    live = cand_valid.sum(1).float()
    print(f"lsh candidates: {float(live.mean()):.0f} valid of {cand.shape[1]} per query "
          f"(min {int(live.min())}, max {int(live.max())}; 1024 held-out queries; "
          f"candidate stage {cand_s * 1e3:.1f} ms)")
    del cand, cand_valid

    t0 = time.perf_counter()
    results = []
    for s in range(0, n_queries, 1024):
        results += db.query(queries[s : s + 1024], 10)
    qs = time.perf_counter() - t0
    print(f"lsh query: {n_queries} queries via db.query in batches of 1024: "
          f"{n_queries / qs:.0f} QPS (facade, results formatted)")
    check(LR.LAUNCHES > 0, "db.query did not launch lsh_rerank")
    check(all(len(r) == 10 and all(np.isfinite(d) for _, d in r) for r in results),
          "every LSH query must return 10 finite results")
    rec["query_qps_1024"] = n_queries / qs
    rec["stream_qps_1024"] = stream_vs_query(
        torch, db, [queries[s : s + 1024] for s in range(0, n_queries, 1024)],
        [results[s : s + 1024] for s in range(0, n_queries, 1024)], "lsh ",
        f"in batches of 1024 over the {n_queries} held-out queries (db.query: {n_queries / qs:.0f} QPS)")

    _, approx, _ = idx.search_arrays(queries[:1024], 10)
    _, exact, _ = TB.brute_force(idx.state, qt, 10, metric=idx.metric)
    exact = exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))
    print(f"lsh recall@10: {recall:.4f} over 1024 held-out queries (vs the exact f32 scan "
          f"of the stored slab)")
    check(recall >= MIN_LSH_RECALL, f"LSH recall@10 {recall} < {MIN_LSH_RECALL}")

    pick = np.linspace(0, n - 1, 256).astype(np.int64)
    hits = db.query(base[pick], 1)
    missed = [int(i) for h, i in zip(hits, pick) if not h or h[0][0] != ids[i]]
    self_rate = 1.0 - len(missed) / len(pick)
    held = [int((idx.state.buckets == idx._id_to_slot.get(ids[i])).any(-1).any(-1).sum())
            for i in missed]
    print(f"lsh self-retrieval: {self_rate:.4f} over 256 inserted rows; overflow "
          f"{st['overflow']} bucket entries displaced; the missed rows sit in "
          f"{held} of {st['tables']} tables")
    check(self_rate >= MIN_LSH_SELF, f"LSH self-retrieval {self_rate} < {MIN_LSH_SELF}")

    gone = ids[1000:1100]
    db.remove(gone)
    back = {i for row in db.query(base[1000:1100], 10) for i, _ in row} & set(gone)
    print(f"lsh remove: 100 ids removed, {len(back)} came back")
    check(not back and len(db) == n - 100, "a removed id came back")
    rec["dedup_s"] = mutate_and_dedup(torch, db, ids, base, "lsh ")

    probe_q = queries[:1024]
    want = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    rec["settle_s"].append(settle(db, "lsh ", "before the save"))
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    del db, idx
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = zt.Database.open(path)
    open_s = time.perf_counter() - t0
    got = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    print(f"lsh save {save_s:.2f} s, open {open_s:.2f} s: same top-10 ids after reopen: "
          f"{got == want}")
    check(got == want and len(db) == n - 110, "reopened LSH database answers differently")

    big = queries[:n_queries]
    db.index.search_arrays(big, 10)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        db.index.search_arrays(big, 10)  # returns host arrays: synchronised
    dev_qps = 3 * n_queries / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    big_rows = db.query(big, 10)
    facade_qps = n_queries / (time.perf_counter() - t0)
    print(f"lsh query: batch {n_queries}: {dev_qps:.0f} QPS (index.search_arrays, "
          f"device synchronised), {facade_qps:.0f} QPS (db.query, results formatted)")
    rec.update(search_arrays_qps=dev_qps, query_qps=facade_qps, stream_qps=stream_vs_query(
        torch, db, [big] * 2, [big_rows] * 2, "lsh ",
        f"at batch {n_queries}, 2 batches (index.search_arrays {dev_qps:.0f}; db.query "
        f"{facade_qps:.0f})"), timeline=submit_timeline(torch, db.index, big, "lsh "))
    launches, slab_launches, large_k = LR.LAUNCHES, LR.LAUNCHES_SLAB, TB.EAGER_LARGE_K
    print(f"launches: lsh_rerank {launches} over the LSH path, {slab_launches} of them the "
          f"slab-major form; eager large-k fallbacks {large_k}")
    check(launches > 0 and large_k == 0, "the LSH path must run through lsh_rerank")
    check(slab_launches == launches, "the LSH path at 1M x 768 must take the slab-major form")

    # the path's own candidates of the 1024 held-out queries (these launches
    # come after the count was read): the kernel against its plain version,
    # then the stages of one device query and the exact scan, by CUDA events
    idx = db.index
    state, S = idx.state, idx.state.slab_capacity
    mc, lossless = idx._candidate_width(probes)
    full = state.num_tables * probes * state.bucket_capacity
    cand, cvalid = TB._candidates(state, qt, probes, mc, lossless)

    def prepare():
        c = cand.int().contiguous()
        return c, state.norms[torch.clamp(c, 0, S - 1).long()], cvalid.float()

    c, norms, valid = prepare()
    args = (state.vectors, qt, c, norms, valid)
    slab_kw = dict(sorted_slots=True, occupied=idx._next_slot)
    check(LR.takes_slab_form(True, state.vectors.dtype, 10, c.shape[1], idx._next_slot),
          "the path's candidates must take the slab-major form")
    # clustered data: hundreds of candidates sit at nearly one distance, so
    # f32 summation order swaps some of them; every differing rank must be
    # such a tie
    worst_err, recalls, ties = 0.0, {}, {}
    _, oracle, _ = TB.brute_force(state, qt, 10, metric=idx.metric)

    def recall_of(pos):  # of the slots behind candidate positions, against the exact scan
        slots = torch.gather(c, 1, pos.clamp(min=0)).long()
        return float((slots[:, :, None] == oracle[:, None, :]).any(-1).float().mean())

    for k in (10, 128):
        wd, wp = LR.lsh_rerank_reference(*args, metric=idx.metric, k=k)
        if k == 10:
            recalls["plain"] = recall_of(wp)
        for form, kw in (("slab", slab_kw), ("gather", {})):
            gd, gp = LR.lsh_rerank(*args, metric=idx.metric, k=k, **kw)
            agree, err = compare(torch, (gd, gp, gp >= 0), (wd, wp, wp >= 0))
            swaps, gap = tie_gap(torch, gp, wp,
                                 lsh_d64(torch, state.vectors, qt, c, norms, idx.metric))
            print(f"parity: lsh_rerank {form} form on the path's candidates, k={k}: position "
                  f"agreement {agree:.6f}, max abs err {err:.3g}, valid results "
                  f"{int((gp >= 0).sum())}; {swaps} differing ranks, all ties (largest f64 "
                  f"gap {gap:.3g} <= {TIE_TOL})")
            worst_err = max(worst_err, err)
            if k == 10:
                recalls[form], ties[form] = recall_of(gp), swaps
            del gd, gp
        del wd, wp
    print(f"recall@10 on the path's candidates against the exact scan of the same state: "
          f"slab form {recalls['slab']:.6f}, gather form {recalls['gather']:.6f}, plain "
          f"{recalls['plain']:.6f}")
    # the forms may differ from the plain version only in verified ties, each of
    # which moves at most one of the 10 * B answers
    check(recalls["slab"] >= recalls["gather"] - (ties["slab"] + ties["gather"]) / c.shape[0] / 10
          and recalls["slab"] >= MIN_LSH_RECALL,
          "the slab-major form answers below the gather form beyond their ties")
    # the two forms in turns on the same arguments: gather, slab, slab, gather
    turns = [time_ms(torch, lambda: LR.lsh_rerank(*args, k=10, **kw), 5)
             for kw in ({}, slab_kw, slab_kw, {})]
    gather_ms, ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    slab128_ms = time_ms(torch, lambda: LR.lsh_rerank(*args, k=128, **slab_kw), 3)
    plain_ms = time_ms(torch, lambda: LR.lsh_rerank_reference(*args, k=10), 1)
    n_valid = float(valid.sum())
    B = c.shape[0]
    stream = (c.numel() * 4 + n_valid * (8 + dim * 4)) / HBM_BYTES_S * 1e3
    seen = torch.zeros(S, dtype=torch.bool, device=c.device)
    seen[c[valid > 0].long()] = True
    rows = int(seen.sum())
    del seen
    # each distinct slab row once, every flag, every valid candidate's slot and norm
    lsh_bound = bound_ms(c.numel() * 4 + n_valid * 8 + rows * dim * 4 + B * (dim * 4 + 80),
                         n_valid * 2 * dim, PEAK_F32)
    print(f"timing: lsh_rerank on the path's candidates, B={B} M={c.shape[1]} "
          f"({n_valid / B:.0f} valid per query, {idx._next_slot} occupied slab rows), in turns "
          f"gather {turns[0]:.3f}, slab {turns[1]:.3f}, slab {turns[2]:.3f}, gather "
          f"{turns[3]:.3f} ms; slab form k=128 {slab128_ms:.3f} ms; plain {plain_ms:.3f} ms; "
          f"every query reading its own rows is {stream:.3f} ms at 3.35 TB/s; bound "
          f"{lsh_bound[0]:.3f} ms by {lsh_bound[1]} ({rows} distinct slab rows among "
          f"{n_valid:.0f} valid candidates, f32 rate): the slab form reaches "
          f"{lsh_bound[0] / ms:.3f} of it, the gather form {lsh_bound[0] / gather_ms:.3f}")
    check(ms < gather_ms, "the slab-major form must beat the gather form where it is taken")
    del args, c, norms, valid, cand, cvalid
    torch.cuda.empty_cache()
    cand_ms = time_ms(torch, lambda: TB._candidates(state, qt, probes, mc, lossless), 2)
    cand, cvalid = TB._candidates(state, qt, probes, mc, lossless)
    prep_ms = time_ms(torch, prepare, 3)
    del cand, cvalid
    torch.cuda.empty_cache()
    passes = -(-B // TB._query_chunk_rows(state, B, full, eager=False))
    query_ms = time_ms(torch, lambda: idx._query_device(qt, 10, exact=False), 2)
    exact_ms = time_ms(torch, lambda: idx._query_device(qt, 10, exact=True), 2)
    print(f"lsh stages, {B} queries, one device query ({passes} passes of the free-memory "
          f"split): whole {query_ms:.3f} ms; candidate stage on all {B} at once "
          f"{cand_ms:.3f} ms, candidate casts and norm gather {prep_ms:.3f} ms, kernel "
          f"(slab form, all {B} at once) {ms:.3f} ms; exact scan (buckets.brute_force) {exact_ms:.3f} ms")
    t0 = time.perf_counter()
    idx.search_arrays(queries[:B], 10)
    lsh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.search_arrays(queries[:B], 10, exact=True)
    exact_s = time.perf_counter() - t0
    print(f"lsh vs exact, {B} queries through index.search_arrays: LSH {lsh_s * 1e3:.1f} ms, "
          f"exact scan {exact_s * 1e3:.1f} ms (host clock, synchronised)")
    del db, idx, state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_slab": slab_launches, "max_abs_err": worst_err,
            "ms": ms, "gather_ms": gather_ms, "plain_ms": plain_ms, "bound_ms": lsh_bound[0],
            "bound_by": lsh_bound[1], "pipeline": rec}


def aug_path(torch, V, TX, IC, device, K=16384, C=128, D=DIM, P=4, B=1024, B_time=N_QUERIES):
    """Phase 9: the augmented-slab surface at the main path's sizing, on the
    synthetic state of the JAX package's ablation tool (random rows, every
    cluster full) with a tenth of the rows tombstoned so that the penalty
    lane decides. Returns the launch count of the driven run, its count by
    form, and each form's record by "<slab>/<kernel form>" (times at
    B=16384, exact=True, beside those at B=1024 and with exact=False)."""
    launches, driven, forms = 0, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        g = torch.Generator(device=device).manual_seed(SEED + 8)
        vecs = torch.empty((K * C, D), dtype=dtype, device=device)
        norms = torch.empty((K * C,), device=device)
        for s in range(0, K * C, 65536):
            x = torch.randn((min(65536, K * C - s), D), generator=g, device=device).to(dtype)
            vecs[s : s + 65536] = x
            norms[s : s + 65536] = (x.float() ** 2).sum(-1)
        valid = torch.rand(K * C, generator=g, device=device) > 0.1
        valid[:C] = False  # cluster 0: nothing live
        counts = torch.full((K + 1,), C, dtype=torch.int32, device=device)
        counts[K] = 0
        st = V.IVFState(centroids=torch.randn((K, D), generator=g, device=device),
                        counts=counts, vectors=vecs, norms=norms, valid=valid,
                        overflow=torch.zeros((), dtype=torch.int32, device=device), ccap=C)
        q = torch.randn((B_time, D), generator=g, device=device)
        probes = V.select_probes(st, q, P, "cosine")
        probes[0] = 0  # query 0 probes only the dead cluster
        aug = TX.augment_slab(vecs, norms, valid, "cosine")
        print(f"aug state ({name}): slab {tuple(vecs.shape)} "
              f"{vecs.numel() * vecs.element_size() / 1e9:.2f} GB, augmented "
              f"{tuple(aug.shape)} {aug.numel() * aug.element_size() / 1e9:.2f} GB, "
              f"{float(valid.float().mean()):.3f} live")

        # the driven run: centroid top-P -> ivf_rerank_aug, f32 dots and
        # one-pass, at B=1024 and B=16384 (the route picks the form), each
        # result held against the plain version on the same inputs
        slab = IC.AugSlab(aug, C)
        driven_err = {}
        TX.LAUNCHES_AUG = 0
        TX.LAUNCHES_AUG_BY_FORM.clear()
        for Bt in (B, B_time):
            want_slots = TX.ivf_rerank_wave(st, q[:Bt], probes[:Bt], 10, "cosine")[1]
            w = TX.aug_query(q[:Bt], "cosine")
            for exact in (True, False):
                got = TX.ivf_rerank_aug(aug, C, q[:Bt], probes[:Bt], 10, "cosine", exact=exact)
                d, slots, ok = got
                torch.cuda.synchronize()
                check(tuple(d.shape) == (Bt, 10) and bool(ok[1:].all()) and not bool(ok[0].any()),
                      "aug re-rank: every query but the dead-cluster one has 10 results")
                check(bool(torch.isfinite(d[ok]).all()) and bool(valid[slots[ok]].all()),
                      "aug re-rank returned a dead row or a non-finite distance")
                form = "cluster" if slab.takes_cluster_form(
                    Bt, P, 10, not exact and dtype == torch.bfloat16) else "query"
                ww = TX._aug_w(aug, w, exact)  # the query as the kernels multiply it
                want = TX.ivf_rerank_aug_reference(aug, C, q[:Bt], probes[:Bt], 10, "cosine",
                                                   exact=exact)
                agree, err, swaps, gap = hold(
                    torch, got, want, lambda b, s: (aug[s].double() * ww[b].double()).sum(-1))
                key = f"{name}/{form}"
                driven_err[key] = max(driven_err.get(key, 0.0), err)
                overlap = float((slots[1:, :, None] == want_slots[1:, None, :]).any(-1)
                                .float().mean())
                print(f"aug path ({name}, B={Bt}, exact={exact}, {form} form): against the "
                      f"plain version slot agreement {agree:.6f}, max abs err {err:.3g}, "
                      f"{swaps} differing ranks, all ties (f64 gap {gap:.3g} <= {TIE_TOL}); "
                      f"top-10 overlap with the one-slab re-rank of the raw slab {overlap:.4f}")
                check(overlap >= 0.9, f"aug re-rank disagrees with the raw slab's: {overlap}")
                del got, d, slots, ok, want, ww
            del want_slots, w
        launches += TX.LAUNCHES_AUG
        driven.update(TX.LAUNCHES_AUG_BY_FORM)
        check(TX.LAUNCHES_AUG == 4, "ivf_rerank_aug did not launch its kernels")
        check(TX.LAUNCHES_AUG_BY_FORM.get(f"{name}/cluster", 0) == 2,
              "the aug re-rank at B=16384 must take the cluster-major form")

        # both forms vs the plain version on this state: the path's probes and
        # a hot cluster that every query but query 0 probes first
        hot = probes[:B].clone()
        hot[1:, 0] = 7
        cases = (("P=4", probes[:B]), ("P=4 hot cluster", hot))
        worst = {f: (1.0, 0.0, 0) for f in ("query", "cluster")}
        for metric in ("cosine", "l2", "sql2"):
            if metric != "cosine":
                del aug, slab
                torch.cuda.empty_cache()
                aug = TX.augment_slab(vecs, norms, valid, metric)
                slab = IC.AugSlab(aug, C)
            w = TX.aug_query(q[:B], metric)
            for exact in (True, False):
                ww = TX._aug_w(aug, w, exact)  # the query as the kernels multiply it

                def d64(b, slot):
                    return (aug[slot].double() * ww[b].double()).sum(-1)

                for _, pr in cases:
                    for k in (10, 128):
                        want = TX.ivf_rerank_aug_reference(aug, C, q[:B], pr, k, metric,
                                                           exact=exact)
                        for form in ("query", "cluster"):
                            got = in_form(IC, form, lambda: TX.ivf_rerank_aug(
                                aug, C, q[:B], pr, k, metric, exact=exact))
                            agree, err, swaps, _ = hold(torch, got, want, d64)
                            check(not bool(got[2][0].any()), "query 0 probes only dead rows")
                            a0, e0, s0 = worst[form]
                            worst[form] = (min(a0, agree), max(e0, err), s0 + swaps)
        for form, (agree, err, swaps) in worst.items():
            print(f"parity: ivf_rerank_aug {name} slab, {form} form, the path's probes and a hot "
                  f"cluster x 3 metrics x exact on/off x k=10/128, B={B} P={P}: worst slot "
                  f"agreement {agree:.6f}, max abs err {err:.3g}; {swaps} differing ranks, all "
                  f"ties (f64 gap <= {TIE_TOL})")
            forms[f"{name}/{form}"] = {"max_abs_err": err}
        for key, err in driven_err.items():
            forms[key]["path_max_abs_err"] = err
        del hot, cases

        # the cluster form's scoring and selection kernels alone (sql2 slab)
        # at both batches, the hot cluster's at B=1024
        for Bt in (B, B_time):
            pr = probes[:Bt].to(torch.int32).contiguous()
            if Bt == B:
                pr[1:, 0] = 7
            w = TX.aug_query(q[:Bt], "sql2").contiguous()
            dist = IC.score_aug(slab, w, pr, False)
            ref = IC.score_reference(slab, w, pr)
            big = ref >= TX.BIG
            check(torch.equal(big, dist >= TX.BIG) and bool((dist[big] == TX.BIG).all()),
                  "aug scoring kernel: BIG on other entries")
            check(bool(torch.allclose(dist[~big], ref[~big], rtol=RTOL, atol=ATOL)),
                  "aug scoring kernel: raw dots beyond RTOL/ATOL")
            got = IC.select(dist, pr, C, 128, positions=True)
            check(all(torch.equal(a, b) for a, b in
                      zip(got, IC.select_reference(dist, pr, C, 128, positions=True))),
                  "aug selection kernel differs from its plain version")
            print(f"parity: ivf_rerank_aug {name} cluster-major form's kernels alone, B={Bt}"
                  f"{' (a hot cluster)' if Bt == B else ''}: scoring buffer within RTOL/ATOL "
                  f"({int(big.sum())} BIG entries equal), selection equal")
            del dist, ref, got, w, pr, big

        # timing on the sql2 slab left from the loop (same bytes for every
        # metric): both forms in turns, exact on and off
        for Bt in (B, B_time):
            args = (aug, C, q[:Bt], probes[:Bt], 10, "sql2")
            reps = 20 if Bt == B else 5
            t = {e: form_turns(torch, lambda f: in_form(IC, f, lambda: TX.ivf_rerank_aug(
                *args, exact=e)), reps) for e in (True, False)}
            plain_ms = time_ms(torch, lambda: TX.ivf_rerank_aug_reference(*args), 2)
            blocks = int(torch.unique(probes[:Bt]).numel())
            Da, item = aug.shape[1], aug.element_size()
            n_bytes = blocks * C * Da * item + Bt * (Da * 4 + P * 4 + 10 * 8)
            bound, by = bound_ms(n_bytes, Bt * P * C * Da * 2, PEAK_F32)
            print(f"timing: ivf_rerank_aug {name} B={Bt} P={P} C={C} D+128={Da} k=10, in turns "
                  f"per-query/cluster/cluster/per-query: exact "
                  f"{'/'.join(f'{x:.3f}' for x in t[True][2])} ms, exact=False "
                  f"{'/'.join(f'{x:.3f}' for x in t[False][2])} ms; plain {plain_ms:.3f} ms; "
                  f"bound {bound:.3f} ms by {by} ({blocks} distinct blocks of {Bt * P} probes, "
                  f"f32 rate): per-query {bound / t[True][0]:.3f} of it, cluster "
                  f"{bound / t[True][1]:.3f}; whole blocks per query are "
                  f"{Bt * P * C * Da * item / HBM_BYTES_S * 1e3:.3f} ms at 3.35 TB/s")
            for i, form in enumerate(("query", "cluster")):
                rec = forms[f"{name}/{form}"]
                if Bt == B:
                    rec.update({"B1024_ms": t[True][i], "B1024_exact_false_ms": t[False][i],
                                "B1024_plain_ms": plain_ms, "B1024_bound_ms": bound})
                else:
                    rec.update({"ms": t[True][i], "exact_false_ms": t[False][i],
                                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
        del st, vecs, norms, valid, aug, slab, q, probes, args, ww
        torch.cuda.empty_cache()
    return launches, driven, forms


def make_documents(n: int, seed: int) -> list[bytes]:
    """``n`` synthetic texts of TEXT_WORDS words each, drawn from a
    TEXT_VOCAB-word synthetic vocabulary (words of 2-10 lowercase letters),
    from one seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    lens = rng.integers(2, 11, TEXT_VOCAB)
    chars = letters[rng.integers(0, 26, int(lens.sum()))].tobytes()
    ends = np.cumsum(lens)
    vocab = np.array([chars[e - n_ : e] for n_, e in zip(lens, ends)], dtype=object)
    counts = rng.integers(TEXT_WORDS[0], TEXT_WORDS[1] + 1, n)
    words = vocab[rng.integers(0, TEXT_VOCAB, int(counts.sum()))]
    ends = np.cumsum(counts)
    return [b" ".join(words[e - c : e]) for c, e in zip(counts, ends)]


def tower_flops(enc, length: int) -> float:
    """Operations of one document through the encoder at ``length`` tokens:
    per layer and token the q/k/v/out and FFN products (2 * in * out each)
    and the attention's two products over ``length`` keys."""
    h, f = enc.tok_embed.weight.shape[1], enc.layers[0].fc1.weight.shape[0]
    per_token = 8 * h * h + 4 * h * f + 4 * length * h
    return float(len(enc.layers) * length * per_token)


def cli_drive(tmp):
    """The text CLI on the card: ``text insert`` through its ``main`` in
    this process, ``python -m zebra_tpu_torch.cli text query`` in a process
    of its own (a fresh process opens what the CLI wrote), then stats and
    clear through ``main`` here (cut from four processes of ~30 s each as
    phases 14, 15 and 16 joined the run), checked as the JAX package's
    ``tests/test_cli.py`` checks its CLI."""
    import contextlib
    import io

    from zebra_tpu_torch.cli import main as cli_main

    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    db = os.path.join(tmp, "cli.zebra")

    def run(*argv, process=True):
        t0 = time.perf_counter()
        args = ["--database-path", db, "text", *argv]
        if process:
            proc = subprocess.run([sys.executable, "-m", "zebra_tpu_torch.cli", *args], cwd=tmp,
                                  env=env, capture_output=True, text=True, timeout=300)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        else:
            out_io, err_io = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out_io), contextlib.redirect_stderr(err_io):
                rc = cli_main(args)
            out, err = out_io.getvalue(), err_io.getvalue()
        check(rc == 0, f"cli text {argv[0]} exited {rc}: {err[-2000:]}")
        return out, time.perf_counter() - t0

    out, t_ins = run("insert", "apple pie recipe", "rocket science", process=False)
    check("Inserted 2" in out and "384-dimensional" in out, f"cli insert printed {out!r}")
    out, t_q = run("query", "apple pie recipe", "-n", "1")
    check("apple pie recipe" in out and "rocket science" not in out, f"cli query printed {out!r}")
    out, t_st = run("stats", process=False)
    info = json.loads(out)
    check(info["records"] == 2 and info["config"]["dim"] == 384 and info["index"]["built"],
          f"cli stats printed {out!r}")
    out, t_cl = run("clear", process=False)
    check(not os.path.exists(db) and not os.path.exists(db + ".d"), "cli clear left files")
    print(f"text cli: text insert through main in this process ({t_ins:.1f} s), python -m "
          f"zebra_tpu_torch.cli text query in its own process ({t_q:.1f} s), stats / clear "
          f"through main in this process ({t_st:.1f} / {t_cl:.1f} s; host clock)")


def canonical_drive(zt, tmp):
    """The verify skill's ``hash-64`` library drive, on the card."""
    path = os.path.join(tmp, "demo.zebra")
    cfg = zt.DatabaseConfig(dim=64, metric="cosine", model="hash-64")
    db = zt.Database.open_or_create(path, cfg)
    ids = db.insert_documents([b"doc one", b"doc two"])
    res = db.query_documents([b"doc one"], number_of_results=3)
    rows = db.query(db.model.embed_documents([b"doc one"]), 1, with_documents=True)
    db.remove([ids[0]])
    db.deduplicate()
    again = zt.Database.open(path)
    kept = again.query_documents([b"doc two"], 1)
    again.clear_database()
    ok = (res[0].get(ids[0]) == b"doc one" and rows[0][0][0] == ids[0]
          and abs(rows[0][0][1]) < 1e-5 and rows[0][0][2] == b"doc one" and len(again) == 0
          and kept == {0: {ids[1]: b"doc two"}} and not os.path.exists(path))
    print(f"canonical drive (hash-64, the verify skill's): insert, query_documents, "
          f"query(with_documents=True), remove, deduplicate, reopen, clear_database: "
          f"{'passed' if ok else 'FAILED'}")
    check(ok, "the canonical hash-64 drive failed on the card")


def text_path(torch, zt, V, R, IC, tmp):
    """Phase 12: the text document path at ``defaults.text_db`` (384
    dimensions, sql2, BGE-small at full width; IVF at the library defaults).
    Returns kernel 1's JSON entry for this path and the phase's record."""
    import numpy as np
    from zebra_tpu_torch import native
    from zebra_tpu_torch import profiling as P
    from zebra_tpu_torch.models import text as MT

    t0 = time.perf_counter()
    docs = make_documents(TEXT_DOCS + TEXT_QUERIES, SEED)
    docs, held = docs[:TEXT_DOCS], docs[TEXT_DOCS:]
    n_words = sum(d.count(b" ") + 1 for d in docs) / len(docs)
    print(f"text data: {TEXT_DOCS} documents + {TEXT_QUERIES} held-out queries, "
          f"{TEXT_WORDS[0]}-{TEXT_WORDS[1]} words from a {TEXT_VOCAB}-word vocabulary (seed "
          f"{SEED}; mean {n_words:.1f} words) in {time.perf_counter() - t0:.2f} s")

    # status and stores
    path = os.path.join(tmp, "text.zebra")
    R.LAUNCHES = 0
    R.LAUNCHES_BY_FORM.clear()
    V.EAGER_LARGE_K = 0
    P.GLOBAL_STATS.ops.clear()
    quant_before = dict(V.QUANT_CALLS)
    db = zt.text_db(path)
    status = db.model_status()
    with open(path) as f:
        manifest = json.load(f)
    print(f"text model_status: {json.dumps(status)}")
    print(f"text stores: native store library loaded: {native.available()}; blob backend "
          f"{manifest['blob_backend']} ({db._docs.codec}); metric {db.config.metric}, "
          f"dim {db.config.dim}, durability {db.config.durability}")
    check(native.available() and manifest["blob_backend"] == "packed"
          and db._docs.codec == "packed-zlib", "the text path must use the native packed store")
    check(db.config.dim == 384 and db.config.metric == "sql2"
          and status["model"] == "bge-small-en-v1.5", "defaults.text_db changed")

    # the tower: card against CPU, batch invariance, forward time
    model = db.model
    enc = model.encoder()
    cpu = MT.BGESmallEn15(device="cpu")
    pairs = list(zip(enc.state_dict().items(), cpu.encoder().state_dict().values()))
    differ = [(k, int((a.cpu() != b).sum()), float((a.cpu() - b).abs().max()))
              for (k, a), b in pairs if not torch.equal(a.cpu(), b)]
    same_weights = not differ
    if differ:  # which tensors, and whether they still change once the card is idle
        torch.cuda.synchronize()
        time.sleep(1.0)
        again = [k for (k, a), b in pairs if not torch.equal(a.cpu(), b)]
        print(f"text tower: {len(differ)} tensors differ from the CPU tower's (name, elements, "
              f"max abs): {differ[:12]}; after a synchronize and 1 s: {len(again)} differ; "
              f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    host = cpu.embed_documents(docs[:256])
    cpu_s = time.perf_counter() - t0
    card = model.embed_documents(docs[:256])
    tower_err = float(np.abs(card - host).max())
    print(f"text tower: {len(enc.layers)} layers, hidden {enc.tok_embed.weight.shape[1]}, "
          f"FFN {enc.layers[0].fc1.weight.shape[0]}, vocabulary {enc.tok_embed.weight.shape[0]}, "
          f"batch {model.batch_size} x {MT.SEQ_LEN} tokens; same weights as the CPU tower: "
          f"{same_weights}; card vs CPU on 256 documents: max abs err {tower_err:.3g} "
          f"(<= {TEXT_TOWER_ATOL}; the CPU tower took {cpu_s:.2f} s)")
    check(same_weights and tower_err <= TEXT_TOWER_ATOL, "the card's tower differs from the CPU's")
    d = docs[777]
    alone = model.embed_documents([d])[0]
    in_100 = model.embed_documents(docs[700:800])[77]
    in_38 = model.embed_documents(docs[740:778])[37]
    bitwise = all(np.array_equal(alone.view(np.uint32), v.view(np.uint32)) for v in (in_100, in_38))
    print(f"text tower: one document alone, at row 77 of 100 and at row 37 of 38 gives "
          f"bitwise the same vector: {bitwise}")
    check(bitwise, "the tower's vector depends on the batch")
    ids_h, attn_h = model.tokenize_padded([t.decode() for t in docs[:model.batch_size]])
    ids_d = torch.from_numpy(ids_h).to(model.device)
    attn_d = torch.from_numpy(attn_h).to(model.device)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: enc(ids_d, attn_d), 20)
    flops = model.batch_size * tower_flops(enc, MT.SEQ_LEN)
    fwd_bound = flops / PEAK_F32 * 1e3
    print(f"text tower forward, batch of {model.batch_size} (CUDA events, f32, TF32 off): "
          f"{fwd_ms:.3f} ms; {flops / 1e9:.1f} GFLOP, f32 bound {fwd_bound:.3f} ms "
          f"({flops / fwd_ms / 1e9:.1f} TFLOP/s, {fwd_bound / fwd_ms:.3f} of the bound)")

    # insert
    t0 = time.perf_counter()
    ids = db.insert_documents(docs)
    insert_s = time.perf_counter() - t0
    st = db.index.stats()
    stages = db.stats.summary()
    embed_s = stages["insert.embed"]["seconds"]
    print(f"text insert: {TEXT_DOCS} documents in {insert_s:.2f} s = {TEXT_DOCS / insert_s:.0f} "
          f"documents/s, of which insert.embed {embed_s:.2f} s = {TEXT_DOCS / embed_s:.0f} "
          f"documents/s (host clock); clusters={st['clusters']}, C={st['cluster_capacity']}, "
          f"spare_used={st['spare_used']}, max load={st['max_cluster_load']}, "
          f"overflow={st['overflow']}")
    check(len(db) == TEXT_DOCS and st["overflow"] == 0, "documents lost on insert")
    check({"insert.embed", "insert.blobs", "insert.wal", "insert.index"} <= set(stages),
          "the insert stage table lacks a stage")
    insert_stages(db, "text ", quant_before)
    rec = {"insert_s": insert_s, "stages": stages | P.GLOBAL_STATS.summary(),
           "forward_ms": fwd_ms, "forward_bound_ms": fwd_bound, "tower_err": tower_err,
           "settle_s": [settle(db, "text ", "after the insert")]}
    doc_of = dict(zip(ids, docs))

    # query_documents of the held-out queries
    q_before = stages.get("query.embed", {}).get("seconds", 0.0)
    t0 = time.perf_counter()
    found = {}
    for s in range(0, TEXT_QUERIES, 1024):
        found.update({s + q: v for q, v in db.query_documents(held[s : s + 1024], 10).items()})
    qs = time.perf_counter() - t0
    q_embed = db.stats.summary()["query.embed"]["seconds"] - q_before
    print(f"text query_documents: {TEXT_QUERIES} queries in batches of 1024, k=10: "
          f"{TEXT_QUERIES / qs:.0f} QPS, of which query.embed {q_embed:.2f} s of {qs:.2f} s "
          f"(host clock); without the embedding {TEXT_QUERIES / (qs - q_embed):.0f} QPS")
    check(len(found) == TEXT_QUERIES and all(len(v) == 10 for v in found.values()),
          "every held-out query must return 10 documents")
    check(all(doc_of[i] == doc for v in found.values() for i, doc in v.items()),
          "a returned document differs from the inserted bytes of its id")
    returned = [i for v in found.values() for i in v]
    t0 = time.perf_counter()
    db._docs.read_many(returned)
    blob_s = time.perf_counter() - t0
    print(f"text blob reads alone: the {len(returned)} returned documents in {blob_s:.2f} s "
          f"({len(returned) / blob_s:.0f} a second, host clock)")
    rec.update(query_qps=TEXT_QUERIES / qs, query_embed_s=q_embed, query_s=qs, blob_read_s=blob_s)

    # self-retrieval, remove, deduplicate
    pick = np.linspace(0, TEXT_DOCS - 1, 1024).astype(np.int64)
    hits = db.query_documents([docs[i] for i in pick], number_of_results=1)
    self_rate = float(np.mean([hits[q] == {ids[i]: docs[i]} for q, i in enumerate(pick)]))
    print(f"text self-retrieval: {self_rate:.4f} over 1024 inserted documents (own id and "
          f"own bytes at number_of_results=1)")
    check(self_rate == 1.0, "an inserted document did not retrieve itself")
    gone = ids[TEXT_REMOVE]
    db.remove(gone)
    back = {i for v in db.query_documents(docs[TEXT_REMOVE], 10).values() for i in v} & set(gone)
    blobs_left = db._docs.read_many(gone)
    print(f"text remove: {len(gone)} ids removed; returned again: {len(back)}; blobs left: "
          f"{len(blobs_left)}")
    check(not back and not blobs_left and len(db) == TEXT_DOCS - len(gone),
          "a removed id came back or kept its blob")
    copies = db.insert_documents(docs[TEXT_DUP_ROWS])
    n = len(db)
    t0 = time.perf_counter()
    db.deduplicate()
    dedup_s = time.perf_counter() - t0
    removed = n - len(db)
    left = sum(i in db.index for i in copies)
    print(f"text deduplicate: {removed} ids removed of {len(copies)} planted copies ({left} "
          f"left; their blobs left: {len(db._docs.read_many(copies))}) in {dedup_s:.3f} s")
    check(removed == len(copies) and left == 0 and not db._docs.read_many(copies)
          and all(i in db.index for i in ids[TEXT_DUP_ROWS]),
          "deduplicate did not remove exactly the planted copies")

    # durability: save, close, reopen
    probe = held[:1024]
    want = db.query_documents(probe, 10)
    rec["settle_s"].append(settle(db, "text ", "before the save"))
    db.save()
    db.close()
    del db
    db = zt.Database.open(path)
    got = db.query_documents(probe, 10)
    print(f"text save, close, reopen: same top-10 and blobs for 1024 held-out queries: "
          f"{got == want}; live documents {len(db)}")
    check(got == want and len(db) == TEXT_DOCS - len(gone), "the reopened database differs")

    # a large batch: kernel 1's cluster-major form at D=384
    bigv = db.model.embed_documents(docs[:N_QUERIES])
    db.query(bigv, 10)  # warm
    t0 = time.perf_counter()
    big_rows = db.query(bigv, 10)
    big_qps = N_QUERIES / (time.perf_counter() - t0)
    live = [q for q in range(N_QUERIES) if not TEXT_REMOVE.start <= q < TEXT_REMOVE.stop]
    big_self = float(np.mean([big_rows[q][0][0] == ids[q] for q in live]))
    launches, by_form = R.LAUNCHES, dict(R.LAUNCHES_BY_FORM)
    print(f"text db.query at batch {N_QUERIES}: {big_qps:.0f} QPS (results formatted); "
          f"self at rank 1 for {big_self:.4f} of the live rows; launches over the path: "
          f"ivf_rerank {launches} {by_form}; eager fallbacks {V.EAGER_LARGE_K}")
    check(by_form.get("int8+residual/query", 0) > 0 and by_form.get("int8+residual/cluster", 0) > 0
          and sum(by_form.values()) == launches and V.EAGER_LARGE_K == 0,
          "the text path must launch both forms of kernel 1")
    rec.update(big_qps=big_qps, dedup_s=dedup_s, launches=by_form)
    rec["misses"] = fault_c_report(torch, V, R, IC, db, bigv, big_rows, ids, docs, live)

    # the CLI and the canonical drive
    cli_drive(tmp)
    canonical_drive(zt, tmp)

    # kernel 1 against its plain version on the path's own index
    idx = db.index
    st, metric, probes_n = idx.state, idx.metric, idx.options.resolved_probes()
    qv = db.model.embed_documents(held)  # bitwise the vectors query_documents searched
    qt = torch.from_numpy(qv).to(idx.device)
    arrays = idx.search_arrays(qv, 10)
    facade = (torch.from_numpy(arrays[0]).to(idx.device),
              torch.from_numpy(arrays[1]).to(idx.device).long(),
              torch.from_numpy(arrays[2]).to(idx.device))
    probes = V.select_probes(st, qt, probes_n, metric, idx.options.probe_sel)
    plain = R.ivf_rerank_reference(st, qt, probes, 10, metric, scan_residual=True)
    if idx._spare_used > 0:
        plain = V._merge_spare(st, qt, *plain, 10, metric, True)
    agree, err, swaps, gap = hold(torch, facade, plain, slab_d64(torch, st, qt, metric, True),
                                  min_agree=0.0)
    rows = idx._format_results(*arrays)
    same_ids = all({i for i, _ in row} == set(v) for row, v in zip(
        rows, db.query_vectors(qv, 10).values()))
    print(f"text parity: the facade's top-10 of the {TEXT_QUERIES} held-out queries against "
          f"kernel 1's plain version on the same index and probes (P={probes_n}, sql2, D=384): "
          f"slot agreement {agree:.6f}, max abs err {err:.3g}; {swaps} differing ranks, all "
          f"ties (largest f64 gap {gap:.3g} <= {TIE_TOL}); query_vectors returns these ids: "
          f"{same_ids}")
    check(same_ids, "query_vectors' ids differ from the facade's top-10")
    _, exact, _ = V.brute_force(st, qt, 10, metric=metric)
    exact = exact.cpu().numpy()
    recalls = {}
    for p in (probes_n, 4, 8):
        pr = V.select_probes(st, qt, p, metric, idx.options.probe_sel)
        found_p = R.ivf_rerank(st, qt, pr, 10, metric, True)[1].cpu().numpy()
        recalls[p] = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(found_p, exact)]))
    facade_recall = float(np.mean([len(set(a) & set(b)) / 10
                                   for a, b in zip(arrays[1], exact)]))
    print(f"text recall@10 over the {TEXT_QUERIES} held-out queries (vs the exact scan of the "
          f"stored int8 + residual reconstruction): query {facade_recall:.4f}; kernel 1 at "
          + ", ".join(f"P={p} {r:.4f}" for p, r in recalls.items())
          + " (no guard: random-init text embeddings are crowded)")
    rec.update(recall=facade_recall, recall_by_probes=recalls)
    path_recs = probe_path_stages(torch, V, R, IC, db, bigv, True, "text ")
    main_form = max(by_form, key=by_form.get).split("/")[1]
    r = path_recs[f"int8+residual/{main_form}"]
    source = {"query": "zebra_tpu_torch/csrc/ivf_rerank.cu",
              "cluster": "zebra_tpu_torch/csrc/ivf_rerank_cluster.cu"}
    entry = {"name": "ivf_rerank", "path": "text documents (D=384, sql2, P=2, k=10)",
             "route": "cuda", "source": source[main_form],
             "replaces": "zebra_tpu/ops/pallas_ivf.py:72", "launches": launches,
             "max_abs_err": max(err, *(x["max_abs_err"] for x in path_recs.values())),
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None,
             "forms": {k: {"source": source[k.split("/")[1]], "launches": by_form.get(k, 0), **v}
                       for k, v in path_recs.items()}}
    del db
    torch.cuda.empty_cache()
    return entry, rec


def stage1_witness(torch, st, q, cell: int, metric: str):
    """``stage1_scores`` for one query ``q [D]``: ``(above, ref_above,
    ref_tied)``, the cells scoring strictly above ``cell`` there (stage 1
    keeps 2P cells, so ``above >= 2P`` drops it), and with the scores
    rounded to bf16 as the reference ranks them, the cells strictly above it
    and those level with it."""
    s = stage1_scores(torch, st, q[None], metric)[0]
    sb = s.float().to(torch.bfloat16)
    return (int((s > s[cell]).sum()), int((sb > sb[cell]).sum()),
            int((sb == sb[cell]).sum()) - 1)


def fault_c_report(torch, V, R, IC, db, qv, rows, ids, docs, live, tag="text ", detail=50,
                   accept=None):
    """Phase 12's batch-16384 misses: every live row whose top-1 is not its
    own id, with its probes and own cell (or the spare), its own f64
    distance beside the rank-1 row's, and the top-1 of the per-query form,
    the cluster form, the plain version and the exact scan on the same
    probes; then where its own cell ranks for its query: by the f64 cell
    score (with the score's gap to the P-th best), among stage 1's 2P
    candidates, and in the insert's placement order (rank > 0: the row was
    spilled past fuller cells). A miss passes only as a property of the data
    or of the reference's design: the rank-1 row at least as near as the
    row itself in f64 (a duplicate), its own cell tied in f64 with the P-th
    probe (within TIE_TOL), the row spilled out of its nearest cells, or its
    own cell dropped by stage 1 of probe selection, witnessed by
    ``stage1_witness``: scored exactly on the bf16-rounded operands, at
    least 2P cells score above it, and the reference's bf16 scores do not
    keep it in every order among equal ones (at least 2P cells above or
    level with it). The first ``detail`` misses are printed one a line,
    then the count of each explanation over all of them. ``accept`` names
    the explanations that pass (default: all but "not live"; a removed
    duplicate passes only on the document paths, which remove them).
    Returns the number of misses."""
    import numpy as np

    idx = db.index
    st, metric = idx.state, idx.metric
    P = idx.options.resolved_probes()
    misses = [q for q in live if rows[q][0][0] != ids[q]]
    print(f"{tag}misses at batch {len(rows)}: {len(misses)} live rows whose top-1 is not "
          f"their own id")
    if not misses:
        return 0
    qt = torch.from_numpy(qv[misses]).to(idx.device)
    probes = V.select_probes(st, qt, P, metric, idx.options.probe_sel)
    stage1 = V.probe_candidates(st, qt, 2 * P, metric)
    placed = V._cell_choice(qt, st.centroids, metric, min(idx.options.spill, st.num_clusters))

    def top1(form):
        return in_form(IC, form, lambda: R.ivf_rerank(st, qt, probes, 10, metric, True))[1][:, 0]

    by_query, by_cluster = top1("query"), top1("cluster")
    plain = R.ivf_rerank_reference(st, qt, probes, 10, metric, scan_residual=True)[1][:, 0]
    exact = V.brute_force(st, qt, 10, metric=metric)[1][:, 0]
    d64 = slab_d64(torch, st, qt, metric, True)
    c64 = st.centroids.double()
    dot64 = qt.double() @ c64.T
    cn2 = (c64 * c64).sum(-1)
    cell64 = (dot64 / cn2.sqrt().clamp(min=1e-30) if metric == "cosine"
              else 2.0 * dot64 - cn2)  # higher is nearer, the placement's order
    row_of = {i: r for r, i in enumerate(ids)}
    C, spare_start = st.cluster_capacity, st.spare_start
    accept = set(accept or ("not live", "nearer in f64", "a tie with the P-th probe", "spilled",
                            "dropped by stage 1's rounding"))
    unexplained = 0
    tally = {"not live": 0, "nearer in f64": 0, "in the spare": 0, "a tie with the P-th probe": 0,
             "spilled": 0, "dropped by stage 1's rounding": 0}
    for b, q in enumerate(misses):
        own = idx._id_to_slot.get(ids[q])
        got = idx._id_to_slot.get(rows[q][0][0])
        same_doc = [r for r in range(len(docs)) if r != q and docs[r] == docs[q]][:4]
        if own is None:
            tally["not live"] += 1
            unexplained += "not live" not in accept
            if b < detail:
                print(f"  row {q}: not live (a duplicate of rows {same_doc} removed by "
                      f"deduplicate)")
            continue
        d_own, d_got = (float(d64(b, torch.tensor([s], device=idx.device))[0])
                        for s in (own, got))
        slots = {name: int(t[b]) for name, t in (("query form", by_query),
                 ("cluster form", by_cluster), ("plain", plain), ("exact", exact))}
        line = (f"  row {q}: probes {probes[b].tolist()}; returned row {row_of.get(rows[q][0][0])} "
                f"(slot {got}) at f64 {d_got:.9g} vs own {d_own:.9g}; same document as rows "
                f"{same_doc}; top-1 slot by "
                + ", ".join(f"{k} {v}{' (own)' if v == own else ''}" for k, v in slots.items()))
        nearer = d_got <= d_own + TIE_TOL * (1 + abs(d_own))
        tally["nearer in f64"] += nearer
        if own >= spare_start:
            if b < detail:
                print(line + "; own slot in the spare")
            tally["in the spare"] += 1
            unexplained += not (nearer and "nearer in f64" in accept)
            continue
        cell = own // C
        order = torch.argsort(cell64[b], descending=True)
        rank = int((order == cell).nonzero()[0, 0])
        pth = float(cell64[b, order[P - 1]])
        gap = pth - float(cell64[b, cell])
        tie = rank >= P and gap <= TIE_TOL * (1 + abs(pth))
        place = placed[b].tolist()
        spilled = place.index(cell) if cell in place else -1
        cand = stage1[b].tolist()
        above, ref_above, ref_tied = stage1_witness(torch, st, qt[b], cell, metric)
        rounding = (cell not in cand and above >= 2 * P
                    and ref_above + ref_tied >= 2 * P)  # the reference may drop it too
        tally["a tie with the P-th probe"] += tie
        tally["spilled"] += spilled > 0
        tally["dropped by stage 1's rounding"] += rounding
        if b < detail:
            print(line + f"; own cell {cell}: f64 rank {rank} (gap to the P-th best {gap:.3g}, "
                  f"a tie: {tie}), among stage 1's {2 * P} candidates {cand}: {cell in cand} "
                  f"(scored exactly on the bf16-rounded operands, {above} cells above it: "
                  f"dropped by the rounding: {rounding}; the reference's bf16 scores put "
                  f"{ref_above} above it and {ref_tied} level with it), placement order {place} "
                  f"(own at {spilled}; > 0 = spilled past fuller cells)")
        found = {"nearer in f64": nearer, "a tie with the P-th probe": tie,
                 "spilled": spilled > 0, "dropped by stage 1's rounding": rounding}
        unexplained += not any(v for k, v in found.items() if k in accept)
    print(f"{tag}misses: the first {min(detail, len(misses))} printed; over all {len(misses)}, "
          f"each may hold several explanations: "
          + ", ".join(f"{k} {v}" for k, v in tally.items()) + f"; unexplained {unexplained}")
    check(not unexplained, f"{unexplained} rows lost their own id and no accepted explanation "
          f"({sorted(accept)}) holds")
    return len(misses)


def settle(db, tag, where):
    """Wait for the database's background retrain and log fold, so that no
    timed section of a phase shares the card or the disk with them; prints
    the waits and the workers' counters. Returns the seconds waited."""
    t0 = time.perf_counter()
    db.wait_for_retrain()
    t1 = time.perf_counter()
    db.wait_for_fold()
    t2 = time.perf_counter()
    print(f"{tag}background workers {where}: waited {t1 - t0:.2f} s for the retrain and "
          f"{t2 - t1:.2f} s for the fold; folds committed {db._fold_count}, retrains "
          f"{db._retrain_count} of {db._retrain_started} started; log {db._delta.size()} bytes")
    check(not any(t is not None and t.is_alive() for t in (db._retrain_thread, db._fold_thread)),
          "a background worker outlived its wait")
    return t2 - t0


def batch_ms(torch, db, q, k=10):
    """One query batch through the facade's pipelined surface: ``(CUDA-event
    ms, host ms, ms waiting for the read lock)``. The events bracket the
    submit under the read lock, so they time what the shared stream ran for
    the batch, kernels a background retrain queued meanwhile included; the
    host time adds the lock wait and the readback."""
    t0 = time.perf_counter()
    with db._lock.read():
        t1 = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        tok = db.index.search_submit(q, k)
        end.record()
    rows = db.index.format_collect(tok)
    host = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end), host, (t1 - t0) * 1e3, len(rows)


def growth_quality(torch, V, index, base, ids, queries, s, e):
    """``{"recall", "fresh", "self"}`` of an index holding ``base[:e]``:
    recall@10 of 1024 held-out queries against its exact scan, and the
    top-1 self-retrieval of 1024 rows just inserted (``base[s:e]``) and of
    1024 rows of all (as ``tests/growth_parity.py`` reads both packages)."""
    import numpy as np

    q = queries[:1024]
    _, approx, _ = index.search_arrays(q, 10)
    _, exact, _ = V.brute_force(index.state, torch.from_numpy(q).to(index.device), 10,
                                metric=index.metric)
    exact = exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))

    def own(lo):
        pick = np.linspace(lo, e - 1, 1024).astype(np.int64)
        return float(np.mean([r[0][0] == ids[i] for r, i in zip(index.search(base[pick], 1),
                                                                   pick)]))

    return {"recall": recall, "fresh": own(s), "self": own(0)}


def growth_path(torch, zt, V, R, IC, tmp, base, queries):
    """Phase 13: a database at the library defaults that users keep filling.
    1/GROWTH_CALLS of ``base`` first, then the rest in GROWTH_CALLS - 1
    equal calls, while a reader thread queries a batch of 1024 every 0.2 s
    (its latency, by whether a retrain or a fold ran meanwhile). After each
    call: the reason the index wants, the workers, K and the spare, the
    exact scan's top-1 for 1024 rows just inserted (every one found: no row
    lost, rows landing while a retrain builds included), and
    ``growth_quality``. After a call in which a retrain committed, what it
    built is held against a cold build of the same rows in a bare index
    (its own k-means draws): the same K and C, a k-means objective at most
    GROWTH_OBJECTIVE_TOL above the cold build's, and recall, fresh and
    whole self-retrieval short of the cold build's by at most GROWTH_COLD_TOL;
    after the first, also against the JAX package's facade on the same
    rows and calls (GROWTH_JAX, floors less GROWTH_JAX_TOL). Then the
    retrains, folds and log, the final shape beside a cold build's, the
    reason left, kernel 1's launches by form, a reopen beside the live
    database (the log replayed) and one after ``close`` (same top-10), and
    an explicit ``index.rebuild()``: every row kept, the exact top-10
    unchanged, recall and self-retrieval those of a cold build. Returns
    kernel 1's launch count by form over the phase and the phase's record."""
    import threading

    import numpy as np
    from zebra_tpu_torch import profiling as P
    from zebra_tpu_torch.index.ivf_host import resolved_clusters

    n, n_queries = base.shape[0], queries.shape[0]
    step = n // GROWTH_CALLS
    path = os.path.join(tmp, "growth.zebra")
    R.LAUNCHES = 0
    R.LAUNCHES_BY_FORM.clear()
    V.EAGER_LARGE_K = 0
    P.GLOBAL_STATS.ops.clear()
    db = zt.Database.create(path, zt.DatabaseConfig(dim=base.shape[1]))
    ids: list[bytes] = []
    calls, samples, witnessed = [], [], []
    stop, pause = threading.Event(), threading.Event()

    def busy():
        return tuple(t is not None and t.is_alive() for t in (db._retrain_thread, db._fold_thread))

    def reader():
        while not stop.wait(0.2):
            if len(db) and not pause.is_set():
                was = busy()
                samples.append((was, busy(), *batch_ms(torch, db, queries[:1024])))

    def spread(cents, e):
        """k-means' objective for ``cents`` over 65,536 rows of ``base[:e]``:
        the mean squared distance to the nearest centroid."""
        x = torch.from_numpy(base[np.linspace(0, e - 1, 65536).astype(np.int64)]).to(cents.device)
        c = cents[:, : x.shape[1]].float()
        total = sum(float(torch.cdist(x[i : i + 8192], c).min(1).values.double().pow(2).sum())
                    for i in range(0, x.shape[0], 8192))
        return total / x.shape[0]

    def cold_build(parts, s, e):
        """A cold build in a bare index of ``base[lo:hi]`` for each part in
        turn: ``(recall etc., (K, C), its k-means objective, seconds)``."""
        cold = db.index._clone_empty()
        cold.defer_rebuild = len(parts) > 1
        t0 = time.perf_counter()
        for lo, hi in parts:
            cold.add(base[lo:hi], ids=ids[lo:hi])
        cold_s = time.perf_counter() - t0
        want = growth_quality(torch, V, cold, base, ids, queries, s, e)
        shape = (cold.state.num_clusters, cold.state.cluster_capacity)
        objective = spread(cold.state.centroids, e)
        del cold
        torch.cuda.empty_cache()
        return want, shape, objective, cold_s

    def against_cold(e, s, got):
        """The retrained index against a cold build of ``base[:e]``. A
        retrain that lands a call after it began holds ``base[:e]`` in an
        index sized for the ``m`` rows it captured (both packages size it
        so): the cold build of ``base[:e]`` is then printed beside it, and
        what is held is a cold build of the same rows in the same order,
        the ``m`` captured, then the rest as its journal replay adds them,
        the cold index's own rebuild reasons deferred."""
        m = db._retrain_log[-1][1]
        mine = (db.index.state.num_clusters, db.index.state.cluster_capacity)
        objective = spread(db.index.state.centroids, e)
        want, shape, cold_obj, cold_s = cold_build([(0, e)], s, e)
        late = ""
        if m < e:
            late = (f"; the retrain captured {m} rows and landed at {e}, so it is held against "
                    f"a cold build of those {m} rows plus the {e - m} its journal replay added")
            print(f"growth retrain at {e} rows: K={mine[0]}, C={mine[1]}, k-means objective "
                  f"{objective:.6g}, {json.dumps(got)}; a cold build of base[:{e}] "
                  f"({cold_s:.2f} s), printed, not held (the retrain was sized for {m} rows): "
                  f"K={shape[0]}, C={shape[1]}, k-means objective {cold_obj:.6g}, "
                  f"{json.dumps(want)}")
            want, shape, cold_obj, cold_s = cold_build([(0, m), (m, e)], s, e)
        print(f"growth retrain at {e} rows: K={mine[0]}, C={mine[1]}, k-means objective "
              f"{objective:.6g}, {json.dumps(got)}; a cold build of the same rows "
              f"({cold_s:.2f} s): K={shape[0]}, C={shape[1]}, k-means objective "
              f"{cold_obj:.6g}, {json.dumps(want)}{late}")
        check(shape == mine and objective <= cold_obj * (1 + GROWTH_OBJECTIVE_TOL)
              and all(got[k] >= want[k] - GROWTH_COLD_TOL for k in want),
              f"the retrain at {e} rows built a worse index than a cold build of its rows")
        if not witnessed:
            ref = GROWTH_JAX
            check(e == ref["live"] and all(got[k] >= ref[k] - GROWTH_JAX_TOL for k in want),
                  f"the first retrain answers below the JAX package's on the same rows {ref}")
        witnessed.append({"live": e, "captured": m, "retrained": got, "cold": want,
                          "cold_s": cold_s, "objective": (objective, cold_obj)})

    sampler = threading.Thread(target=reader, name="growth-reader", daemon=True)
    sampler.start()
    t_start = time.perf_counter()
    try:
        for c in range(GROWTH_CALLS):
            s, e = c * step, (n if c == GROWTH_CALLS - 1 else (c + 1) * step)
            before = db._retrain_count
            t0 = time.perf_counter()
            ids += db.insert_vectors(base[s:e])
            dt = time.perf_counter() - t0
            idx = db.index
            wanted, (retraining, folding) = idx._rebuild_wanted, busy()
            pick = np.linspace(s, e - 1, 1024).astype(np.int64)
            found = float(np.mean([h[0][0] == ids[i] for h, i in zip(
                idx.search(base[pick], 1, exact=True), pick)]))
            held = db.query(queries[:1024], 10)
            got = growth_quality(torch, V, idx, base, ids, queries, s, e)
            st = idx.stats()
            print(f"growth call {c + 1}/{GROWTH_CALLS}: +{e - s} rows in {dt:.2f} s ({len(db)} "
                  f"live); reason wanted {wanted}; retrain running {retraining}, fold running "
                  f"{folding}; K={st['clusters']}, C={st['cluster_capacity']}, spare "
                  f"{st['spare_used']}/{st['spare_capacity']}; retrains {db._retrain_count}, "
                  f"folds {db._fold_count}; the exact scan finds {found:.4f} of 1024 rows just "
                  f"inserted; {json.dumps(got)}")
            calls.append({"s": dt, "wanted": wanted, "retraining": retraining,
                          "folding": folding, "K": st["clusters"], "C": st["cluster_capacity"],
                          "spare_used": st["spare_used"], "self_exact": found, **got})
            check(found == 1.0, "a row just inserted is missing from the index")
            check(all(len(r) == 10 and all(np.isfinite(d) for _, d in r) for r in held),
                  "every held-out query must return 10 finite results")
            if db._retrain_count > before and not retraining:
                pause.set()
                try:
                    against_cold(e, s, got)
                finally:
                    pause.clear()
        insert_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        db.wait_for_retrain()
        wait_retrain = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.wait_for_fold()
        wait_fold = time.perf_counter() - t0
    finally:
        stop.set()
        sampler.join(60)
    check(not sampler.is_alive() and samples and all(m == 1024 for *_, m in samples),
          "the reader thread failed or hung")
    check(len(witnessed) == db._retrain_count >= 1,
          "every retrain must be held against a cold build of its rows")
    idx = db.index
    st = idx.stats()
    stages = P.GLOBAL_STATS.summary()
    print(f"growth: {n} rows in {GROWTH_CALLS} calls, {insert_s:.2f} s of calls, checks and "
          f"cold builds; then waited {wait_retrain:.2f} s for the retrain, {wait_fold:.2f} s "
          f"for the fold")
    print(f"growth retrains: started {db._retrain_started}, committed {db._retrain_count}, "
          f"drained on the mutating thread {db._retrain_drains}; each (reason, live rows, "
          f"wall s): {[(r, m, round(t, 3)) for r, m, t in db._retrain_log]}")
    print("growth stages: " + json.dumps({k: v for k, v in stages.items()
                                          if k.split(".")[0] in ("retrain", "rebuild", "ivf")}))

    def lat(rows):
        if not rows:
            return None
        out = {"n": len(rows)}
        for key, i in (("event_ms", 2), ("host_ms", 3), ("lock_ms", 4)):
            v = sorted(r[i] for r in rows)
            out[key] = [round(v[len(v) // 2], 3), round(v[-1], 3)]
        return out

    reader_rec = {"retrain": lat([r for r in samples if r[0][0] or r[1][0]]),
                  "fold": lat([r for r in samples if (r[0][1] or r[1][1])
                               and not (r[0][0] or r[1][0])]),
                  "idle": lat([r for r in samples if not any(r[0] + r[1])])}
    print(f"growth reader: a batch of 1024 every 0.2 s during the growth (search_submit "
          f"under the read lock, format_collect; paused over the cold builds), by what ran "
          f"beside it: [median, max] of the CUDA events around the submit (the shared "
          f"stream's time for it), of the host clock and of its wait for the read lock: "
          f"{json.dumps(reader_rec)}")
    threshold = db._fold_threshold()
    log_bytes = db._delta.size()
    print(f"growth folds committed {db._fold_count}; log {log_bytes} bytes left (fold threshold "
          f"{threshold}: the floor {db._fold_floor}, or the snapshot's bytes when larger)")
    after = sorted(batch_ms(torch, db, queries[:1024]) for _ in range(5))[2]
    print(f"growth: one batch of 1024 after the workers, median of 5: {after[0]:.3f} ms "
          f"(CUDA events), {after[1]:.3f} ms host")
    reader_rec["after"] = after[:3]
    rec = {"insert_s": insert_s, "calls": calls, "retrains": db._retrain_log,
           "retrain_started": db._retrain_started, "retrain_drains": db._retrain_drains,
           "witnessed": witnessed, "folds": db._fold_count, "log_bytes": log_bytes,
           "reader": reader_rec, "stages": stages, "wait_retrain_s": wait_retrain,
           "wait_fold_s": wait_fold}

    missing = sum(i not in idx for i in ids)
    cold_k = resolved_clusters(idx.options, n)
    reason = idx._rebuild_reason()
    print(f"growth final: {len(db)} live, {missing} ids missing; K={st['clusters']} (a cold "
          f"build of {n} rows resolves to {cold_k}), C={st['cluster_capacity']}, spare "
          f"{st['spare_used']}/{st['spare_capacity']}, rebuild reason now {reason}")
    check(len(db) == n and not missing, "the growing database lost rows")
    check(st["clusters"] > calls[0]["K"], "no retrain re-sized the growing index")
    check(reason is None, "a rebuild is still wanted after the growth")
    check(db._fold_count >= 1 and log_bytes <= threshold,
          "no fold committed, or the log stayed past the fold threshold")
    big = idx.search_arrays(queries, 10)[1]  # batch 16384: the cluster-major form
    check(big.shape == (n_queries, 10), "the batch-16384 query returned another shape")
    launches = dict(R.LAUNCHES_BY_FORM)
    print(f"growth launches: ivf_rerank {R.LAUNCHES} {launches}")
    check(launches.get("int8+residual/query", 0) > 0
          and launches.get("int8+residual/cluster", 0) > 0
          and sum(launches.values()) == R.LAUNCHES and V.EAGER_LARGE_K == 0,
          "the growing database must launch both forms of kernel 1")
    rec.update(launches=launches, K=st["clusters"], cold_K=cold_k)

    # recovery: reopen beside the live database (a crash), then close and reopen
    probe = queries[:1024]
    want = [[i for i, _ in r] for r in db.query(probe, 10)]
    t0 = time.perf_counter()
    crashed = zt.Database.open(path)
    crash_open_s = time.perf_counter() - t0
    crashed.wait_for_retrain()
    got = [[i for i, _ in r] for r in crashed.query(probe, 10)]
    exact_live = [{i for i, _ in r} for r in db.index.search(probe, 10, exact=True)]
    exact_got = [{i for i, _ in r} for r in crashed.index.search(probe, 10, exact=True)]
    print(f"growth reopen without a close: {crash_open_s:.2f} s, replaying {log_bytes} log "
          f"bytes; {len(crashed)} live; the same top-10 of 1024 held-out queries by the query "
          f"{np.mean([a == b for a, b in zip(got, want)]):.4f}, by the exact scan "
          f"{np.mean([a == b for a, b in zip(exact_got, exact_live)]):.4f}")
    check(exact_got == exact_live and len(crashed) == n,
          "the database reopened after a crash holds other rows")
    del crashed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db.close()
    close_s = time.perf_counter() - t0
    left = os.path.getsize(os.path.join(f"{path}.d", "delta.log"))
    t0 = time.perf_counter()
    db = zt.Database.open(path)
    open_s = time.perf_counter() - t0
    got = [[i for i, _ in r] for r in db.query(probe, 10)]
    print(f"growth close {close_s:.2f} s, open {open_s:.2f} s replaying {left} log bytes; "
          f"same top-10: {got == want}")
    check(got == want and len(db) == n, "the reopened database differs")
    rec.update(crash_open_s=crash_open_s, close_s=close_s, open_s=open_s)

    # an explicit rebuild of the grown refined-int8 index keeps every row
    exact_before = [{i for i, _ in r} for r in db.index.search(probe, 10, exact=True)]
    P.GLOBAL_STATS.ops.clear()
    t0 = time.perf_counter()
    with db._lock.write():
        db.index.rebuild("explicit")
    rebuild_s = time.perf_counter() - t0
    exact_after = [{i for i, _ in r} for r in db.index.search(probe, 10, exact=True)]
    same = float(np.mean([a == b for a, b in zip(exact_before, exact_after)]))
    print(f"growth explicit rebuild: {rebuild_s:.2f} s ({json.dumps(P.GLOBAL_STATS.summary())}); "
          f"{len(db)} live, K={db.index.state.num_clusters}; the exact top-10 id set is the "
          f"same for {same:.4f} of 1024 held-out queries")
    after_rebuild = growth_quality(torch, V, db.index, base, ids, queries, 0, n)
    print(f"growth after the explicit rebuild: {json.dumps(after_rebuild)}")
    check(len(db) == n and all(i in db.index for i in ids[::997]), "the rebuild lost rows")
    check(same >= MIN_SLOT_AGREEMENT, "the rebuild changed the exact top-10")
    check(db.index.state.num_clusters == cold_k and after_rebuild["recall"] >= MIN_RECALL,
          "the rebuilt index does not answer as a cold build does")
    if after_rebuild["self"] < 1.0:
        # a miss passes only as a stage-1 rounding drop that stage1_witness
        # confirms (fault C, a behaviour of the reference), and is printed;
        # a lost row or any other miss fails (the phase's launches were
        # read above)
        pick = np.linspace(0, n - 1, 1024).astype(np.int64)
        misses = fault_c_report(
            torch, V, R, IC, db, base[pick], db.index.search(base[pick], 1),
            [ids[i] for i in pick], [base[i].tobytes() for i in pick], range(1024),
            tag="growth rebuilt ", accept=("dropped by stage 1's rounding",))
        print(f"growth after the explicit rebuild: {misses} of 1024 rows miss their own id, "
              f"each a stage-1 rounding drop (fault C)")
    rec.update(rebuild_s=rebuild_s, rebuild_same=same, after_rebuild=after_rebuild)
    db.close()
    del db
    torch.cuda.empty_cache()
    return launches, rec


def sharded_path(torch, zt, V, R, IC, LR, tmp, base, queries):
    """Phase 16: the sharded database on the card. ``DatabaseConfig(dim=768,
    shards=4)`` with ``device="cuda"`` (every shard on this card): a durable
    insert of the 1M rows in one call, the 16,384 held-out queries at batch
    1024 and 16384 through ``search_arrays`` and ``db.query`` (recall@10
    against the sharded exact scan), self-retrieval of 1024 rows, removes,
    kernel 1's launches by form and by shard over that drive; then one
    shard's kernel against its plain version on the same probes (both
    forms), the device query and its merge by CUDA events, save and reopen
    at 4 shards (the same top-10), a reshard on load to 2 (the same exact
    top-10 and recall); LSH over 4 shards on the first SHARD_LSH_ROWS rows
    (recall, kernel 4's launches); BGE-small and ViT ``embeddings_mean``
    tensor-parallel over a (data=2, model=4) grid of this card against the
    single-device towers. Returns kernel 1's launch count by form over the
    drive, kernel 4's launches (all, slab-major) and the phase's record."""
    import numpy as np
    from zebra_tpu_torch import profiling as P
    from zebra_tpu_torch.index import buckets as TB
    from zebra_tpu_torch.models import image as MI
    from zebra_tpu_torch.models import text as MT
    from zebra_tpu_torch.parallel import make_tower_mesh
    from zebra_tpu_torch.parallel.sharded import ShardedIndex, merge_partials

    dev = torch.device("cuda", 0)
    n = base.shape[0]
    path = os.path.join(tmp, "sharded.zebra")
    rec = {}
    by_shard = [{} for _ in range(SHARDS)]
    query = V.query
    db = None

    def counted(st, *a, **kw):
        """``ivf.query`` with kernel 1's launches credited to the shard whose
        state it was given."""
        before = dict(R.LAUNCHES_BY_FORM)
        out = query(st, *a, **kw)
        shard = next((i for i, x in enumerate(db.index.state or ()) if x is st), None)
        if shard is not None:
            for key, c in R.LAUNCHES_BY_FORM.items():
                if c > before.get(key, 0):
                    by_shard[shard][key] = by_shard[shard].get(key, 0) + c - before.get(key, 0)
        return out

    # the main drive: the counts are zero here and read right after it
    R.LAUNCHES = 0
    R.LAUNCHES_BY_FORM.clear()
    V.EAGER_LARGE_K = 0
    P.GLOBAL_STATS.ops.clear()
    V.query = counted
    try:
        db = zt.Database.create(path, zt.DatabaseConfig(dim=DIM, shards=SHARDS), device="cuda")
        idx = db.index
        check(isinstance(idx, ShardedIndex) and idx.shards == SHARDS
              and idx.shard_devices == [dev] * SHARDS and idx.options.rerank == "cuda"
              and idx.options.refine == "scan", "shards=4 on the card must hold 4 IVF states "
              "at the defaults on cuda:0, re-ranked by kernel 1")
        t0 = time.perf_counter()
        ids = db.insert_vectors(base)
        torch.cuda.synchronize()
        insert_s = time.perf_counter() - t0
        wait_s = settle(db, "sharded ", "after the insert")
        st = idx.stats()
        print(f"sharded insert: {n} x {DIM} durable rows over {SHARDS} shards in one call, "
              f"{insert_s:.2f} s ({n / insert_s:.0f} rows/s); stages {json.dumps(db.stats.summary())}; "
              f"{json.dumps(P.GLOBAL_STATS.summary())}; index {json.dumps(st)}; log codec "
              f"{idx._wal_codec}")
        check(len(db) == n and st["clusters_per_shard"] == 16384 and st["cluster_capacity"] == 32
              and idx.state[0].spare_capacity >= 16384,
              "each shard must hold an unsharded 1M-row index's 16,384 cells, 32 rows deep, "
              "and the spare of its 250,000 rows")
        q16 = queries
        _, approx, _ = idx.search_arrays(q16, 10)  # the first call at this shape warms
        _, approx1k, _ = zip(*(idx.search_arrays(q16[s:s + 1024], 10)
                                for s in range(0, N_QUERIES, 1024)))
        rows16 = db.query(q16, 10)
        arrays_s = time_ms_host(lambda: idx.search_arrays(q16, 10), 3) / 1e3
        arrays1k_s = time_ms_host(lambda: [idx.search_arrays(q16[s:s + 1024], 10)
                                           for s in range(0, N_QUERIES, 1024)], 2) / 1e3
        query_s = time_ms_host(lambda: db.query(q16, 10), 2) / 1e3
        query1k_s = time_ms_host(lambda: [db.query(q16[s:s + 1024], 10)
                                          for s in range(0, N_QUERIES, 1024)], 2) / 1e3
        pick = np.linspace(0, n - 1, 1024).astype(np.int64)
        own = np.array([idx._id_to_slot.get(ids[i]) for i in pick])
        _, top1, _ = idx.search_arrays(base[pick], 1)
        self_ret = float(np.mean(top1[:, 0] == own))
        named = [[i for i, _ in r] for r in rows16]
        same_rows = named == [idx._slot_ids.take_list(r) for r in approx]
        gone = ids[SHARD_REMOVE]
        db.remove(gone)
        gone_set = set(gone)
        returned = sum(i in gone_set for r in db.query(base[SHARD_REMOVE], 10) for i, _ in r)
    finally:
        V.query = query
    forms, launches = dict(R.LAUNCHES_BY_FORM), R.LAUNCHES
    print(f"sharded kernel 1 over the drive: {launches} launches {forms}; by shard "
          f"{by_shard}; eager re-ranks {V.EAGER_LARGE_K}")
    check(launches > 0 and V.EAGER_LARGE_K == 0 and all(by_shard)
          and forms.get("int8+residual/cluster", 0) > 0 and forms.get("int8+residual/query", 0) > 0,
          "every shard must run kernel 1, both forms over the drive")
    exact = np.concatenate([idx.search_arrays(q16[s:s + 1024], 10, exact=True)[1]
                            for s in range(0, N_QUERIES, 1024)])
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))
    recall1k = float(np.mean([len(set(a) & set(b)) / 10
                              for a, b in zip(np.concatenate(approx1k), exact)]))
    print(f"sharded queries: recall@10 of {N_QUERIES} held-out queries against the sharded exact "
          f"scan {recall:.4f} at batch 16384, {recall1k:.4f} at 1024; search_arrays "
          f"{N_QUERIES / arrays_s:.0f} QPS at 16384, {N_QUERIES / arrays1k_s:.0f} at 1024; "
          f"db.query {N_QUERIES / query_s:.0f} QPS at 16384, {N_QUERIES / query1k_s:.0f} at 1024 "
          f"(the same ids as search_arrays: {same_rows}); self-retrieval of 1024 rows "
          f"{self_ret:.4f}; removed ids returned {returned}")
    check(recall >= MIN_RECALL and recall1k >= MIN_RECALL, "sharded recall@10 below the floor")
    check(same_rows, "db.query and search_arrays answer differently")
    check(self_ret == 1.0, "an inserted row does not find itself")
    check(returned == 0, "removed ids came back")
    rec.update(insert_s=insert_s, insert_rows_s=n / insert_s, fold_wait_s=wait_s, recall=recall,
               recall_1024=recall1k, arrays_qps=N_QUERIES / arrays_s,
               arrays_qps_1024=N_QUERIES / arrays1k_s, query_qps=N_QUERIES / query_s,
               query_qps_1024=N_QUERIES / query1k_s, self=self_ret, launches=forms,
               by_shard=by_shard)

    # one shard's kernel against its plain version on that shard's probes;
    # the device query, its shards and its merge by CUDA events
    st0, metric, Pr = idx.state[0], idx.metric, idx.options.resolved_probes()
    for B in (1024, N_QUERIES):
        qt = torch.from_numpy(q16[:B]).to(dev)
        probes = V.select_probes(st0, qt, Pr, metric, idx.options.probe_sel)
        want = R.ivf_rerank_reference(st0, qt, probes, 10, metric, scan_residual=True)
        d64 = slab_d64(torch, st0, qt, metric, residual=True)
        for form in ("query", "cluster"):
            got = in_form(IC, form, lambda: R.ivf_rerank(st0, qt, probes, 10, metric, True))
            agree, err, swaps, gap = hold(torch, got, want, d64, min_agree=0.0)
            print(f"sharded parity: shard 0's ivf_rerank int8+residual {form} form, B={B} "
                  f"P={Pr} k=10: slot agreement {agree:.6f}, max abs err {err:.3g}; {swaps} "
                  f"differing ranks, all ties (largest f64 gap {gap:.3g} <= {TIE_TOL})")
            rec[f"parity_max_abs_err_{form}"] = max(err, rec.get(f"parity_max_abs_err_{form}", 0))
        whole = time_ms(torch, lambda: idx._query_device(qt, 10, False), 10)
        shard_ms = time_ms(torch, lambda: idx._partials(qt, 10, False), 10)
        parts = idx._partials(qt, 10, False)
        merge = time_ms(torch, lambda: merge_partials(parts, 10, dev), 20)
        print(f"sharded device query, B={B}: {whole:.3f} ms, of which the {SHARDS} shards' "
              f"queries {shard_ms:.3f} ms and the merge of their [{SHARDS}, {B}, 10] partials "
              f"{merge:.3f} ms (share {merge / whole:.4f})")
        rec[f"device_ms_{B}"], rec[f"merge_ms_{B}"] = whole, merge
        del probes, want, parts

    # save and reopen at 4 shards; reopen resharded to 2
    probe = q16[:1024]
    want = [[i for i, _ in r] for r in db.query(probe, 10)]
    exact4 = db.index.search(probe, 10, exact=True)
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = zt.Database.open(path, device="cuda")
    open_s = time.perf_counter() - t0
    got = [[i for i, _ in r] for r in again.query(probe, 10)]
    print(f"sharded save {save_s:.2f} s, open {open_s:.2f} s: {again.index.shards} shards, "
          f"{len(again)} live; the same top-10 of 1024 held-out queries: {got == want}")
    check(got == want and again.index.shards == SHARDS, "the reopened sharded database differs")
    del again
    t0 = time.perf_counter()
    two = ShardedIndex.load(os.path.join(f"{path}.d", "index"), shards=2, device="cuda")
    reshard_s = time.perf_counter() - t0
    exact2 = two.search(probe, 10, exact=True)
    same_ids = float(np.mean([[i for i, _ in a] == [i for i, _ in b]
                              for a, b in zip(exact2, exact4)]))
    dist_gap = max(abs(da - db_) / (1.0 + abs(db_)) for a, b in zip(exact2, exact4)
                   for (_, da), (_, db_) in zip(a, b))
    _, a2, _ = two.search_arrays(probe, 10)
    _, e2, _ = two.search_arrays(probe, 10, exact=True)
    recall2 = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(a2, e2)]))
    st2 = two.stats()
    print(f"sharded reshard on load 4 -> 2: {reshard_s:.2f} s, {len(two)} live, "
          f"{st2['clusters_per_shard']} clusters of {st2['cluster_capacity']} a shard; the exact "
          f"top-10 of 1024 held-out queries the same ids for {same_ids:.4f} (largest relative "
          f"distance gap rank by rank {dist_gap:.3g}); recall@10 {recall2:.4f}")
    check(len(two) == len(db) and two.shards == 2, "the reshard lost rows")
    check(same_ids == 1.0 or dist_gap <= TIE_TOL, "the resharded exact top-10 differs beyond ties")
    check(recall2 >= MIN_RECALL, "the resharded index's recall is below the floor")
    rec.update(save_s=save_s, open_s=open_s, reshard_s=reshard_s, reshard_recall=recall2,
               reshard_same_exact=same_ids)
    del two, db, idx, st0
    torch.cuda.empty_cache()

    # LSH over 4 shards; kernel 4's launches over its queries
    lpath = os.path.join(tmp, "sharded_lsh.zebra")
    LR.LAUNCHES = 0
    LR.LAUNCHES_SLAB = 0
    TB.EAGER_LARGE_K = 0
    lsh = zt.Database.create(lpath, zt.DatabaseConfig(
        dim=DIM, shards=SHARDS, index=zt.IndexOptions(index_type="lsh")), device="cuda")
    rows = base[:SHARD_LSH_ROWS]
    t0 = time.perf_counter()
    lids = lsh.insert_vectors(rows)
    torch.cuda.synchronize()
    lsh_insert_s = time.perf_counter() - t0
    settle(lsh, "sharded lsh ", "after the insert")
    t0 = time.perf_counter()
    _, la, _ = lsh.index.search_arrays(probe, 10)
    lsh_query_s = time.perf_counter() - t0
    _, lt1, _ = lsh.index.search_arrays(rows[pick[pick < SHARD_LSH_ROWS]], 1)
    lsh_launches, lsh_slab = LR.LAUNCHES, LR.LAUNCHES_SLAB
    _, le, _ = lsh.index.search_arrays(probe, 10, exact=True)
    lrecall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(la, le)]))
    lown = np.array([lsh.index._id_to_slot.get(lids[i]) for i in pick[pick < SHARD_LSH_ROWS]])
    lself = float(np.mean(lt1[:, 0] == lown))
    print(f"sharded lsh: {SHARD_LSH_ROWS} rows over {SHARDS} shards in {lsh_insert_s:.2f} s; "
          f"{json.dumps(lsh.index.stats())}; recall@10 of 1024 held-out queries {lrecall:.4f} "
          f"({1024 / lsh_query_s:.0f} QPS at 1024); self-retrieval {lself:.4f} of {len(lown)}; "
          f"kernel 4: {lsh_launches} launches ({lsh_slab} slab-major), eager re-ranks "
          f"{TB.EAGER_LARGE_K}")
    check(lrecall >= MIN_LSH_RECALL and lsh_launches > 0 and TB.EAGER_LARGE_K == 0,
          "sharded LSH must run kernel 4 on every shard and reach its recall floor")
    check(lself >= MIN_LSH_SELF, "sharded LSH rows do not find themselves")
    rec.update(lsh_recall=lrecall, lsh_self=lself, lsh_insert_s=lsh_insert_s,
               lsh_launches=lsh_launches, lsh_launches_slab=lsh_slab)
    del lsh
    torch.cuda.empty_cache()

    # the tensor-parallel towers on a (data, model) grid of this card
    mesh = make_tower_mesh(TP_GRID[1], TP_GRID[0], [dev] * (TP_GRID[0] * TP_GRID[1]))
    docs = make_documents(TP_DOCS, SEED + 16)
    single_t, tp_t = MT.BGESmallEn15(), MT.BGESmallEn15(mesh=mesh)
    text_err = float(np.abs(tp_t.embed_documents(docs) - single_t.embed_documents(docs)).max())
    ids_t, attn_t = (torch.from_numpy(a).to(dev) for a in single_t.tokenize_padded(
        [d.decode() for d in docs[:single_t.batch_size]]))
    with torch.inference_mode():
        one_ms = time_ms(torch, lambda: single_t.encoder()(ids_t, attn_t), 5)
        tp_ms = time_ms(torch, lambda: tp_t.encoder()(ids_t, attn_t), 5)
    images = [make_image(i) for i in range(TP_IMAGES)]
    single_i, tp_i = MI.VitImageModel(), MI.VitImageModel(mesh=mesh)
    image_err = float(np.abs(tp_i.embed_documents(images) - single_i.embed_documents(images)).max())
    print(f"sharded towers on a (data={TP_GRID[0]}, model={TP_GRID[1]}) grid of one card: "
          f"BGE-small on {TP_DOCS} documents max abs err {text_err:.3g} against the "
          f"single-device tower (a batch of {single_t.batch_size}: {tp_ms:.3f} ms against "
          f"{one_ms:.3f} ms); ViT embeddings_mean on {TP_IMAGES} images {image_err:.3g} "
          f"(<= {TP_ATOL})")
    check(text_err <= TP_ATOL and image_err <= TP_ATOL,
          "a tensor-parallel tower differs from its single-device tower")
    rec.update(tp_text_err=text_err, tp_image_err=image_err, tp_text_ms=tp_ms,
               text_ms=one_ms)
    return forms, {"launches": lsh_launches, "launches_slab": lsh_slab}, rec


def dist64(torch, metric, a, b, power=3.0):
    """f64 distances of broadcast rows ``a [..., D]`` and ``b [..., D]``
    (f64 tensors holding f32 values): the twelve metrics stated again,
    independently of ``ops/distances.py`` (hamming: a popcount table of the
    low bytes of the f32 bit patterns)."""
    if metric in ("cosine", "sql2", "l2"):
        return metric64(torch, metric, (a * b).sum(-1), (a * a).sum(-1), (b * b).sum(-1))
    if metric == "hamming":
        table = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.float64,
                             device=a.device)
        bits = (a.float().view(torch.int32) ^ b.float().view(torch.int32)) & 0xFF
        return table[bits.long()].sum(-1)
    d = (a - b).abs()
    if metric == "chebyshev":
        return d.amax(-1)
    if metric == "canberra":
        den = a.abs() + b.abs()
        return torch.where(den > 0, d / den.clamp(min=1e-300), 0.0).sum(-1)
    if metric == "braycurtis":
        den = (a + b).abs().sum(-1)
        return torch.where(den > 0, d.sum(-1) / den.clamp(min=1e-300), 0.0)
    if metric == "manhattan":
        return d.sum(-1)
    if metric == "minkowski":
        return (d ** power).sum(-1) ** (1.0 / power)
    if metric == "p_norm":
        return (d ** power).sum(-1)
    return (d ** {"l3": 3, "l4": 4}[metric]).sum(-1) ** (1.0 / {"l3": 3, "l4": 4}[metric])


def exact64_topk(torch, metric, rows, valid, q, k, power=3.0):
    """``(f64 distances [B, k] ascending, slots [B, k])`` of queries ``q``
    over the stored rows ``rows [S, D]`` (live where ``valid``), in f64:
    the Gram metrics by f64 GEMMs of 131,072-row chunks, the elementwise
    ones by ``dist64`` in chunks of at most 512 MiB of f64 differences."""
    B, D = q.shape
    q64 = q.double()
    mxu = metric in ("cosine", "sql2", "l2")
    chunk = 131072 if mxu else max(256, (1 << 29) // (B * D * 8))
    inf = float("inf")
    best_d = torch.full((B, k), inf, dtype=torch.float64, device=q.device)
    best_s = torch.full((B, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, rows.shape[0], chunk):
        x = rows[s : s + chunk].double()
        if mxu:
            d = metric64(torch, metric, q64 @ x.T, (q64 * q64).sum(-1)[:, None],
                         (x * x).sum(-1)[None, :])
        else:
            d = dist64(torch, metric, q64[:, None, :], x[None, :, :], power)
        d = torch.where(valid[s : s + chunk][None, :], d, inf)
        slots = torch.arange(s, s + x.shape[0], device=q.device).expand(B, -1)
        best_d, pos = torch.cat([best_d, d], 1).topk(k, dim=1, largest=False)
        best_s = torch.gather(torch.cat([best_s, slots], 1), 1, pos)
    return best_d, best_s


def hold_exact(torch, metric, rows, got_slots, q, top64, power=3.0):
    """An exact top-k held to the f64 answer: at every rank the f64 distance
    of the returned row must equal the f64 top-k's within TIE_TOL (relative
    to 1 + |d|), so every rank where the ids differ is an f64 tie. Returns
    ``(ranks whose ids differ, largest relative gap)``."""
    d_top, s_top = top64
    g = torch.as_tensor(got_slots, device=q.device).long()
    d_got = dist64(torch, metric, q.double()[:, None, :], rows[g.clamp(min=0)].double(), power)
    gap = float(((d_got - d_top).abs() / (1.0 + d_top.abs())).max())
    differ = int((g != s_top).sum())
    check(bool((g >= 0).all()) and gap <= TIE_TOL,
          f"{metric}: an exact top-{g.shape[1]} rank is {gap} from the f64 answer (> {TIE_TOL})")
    return differ, gap


def flat_path(torch, zt, V, TB, R, tmp, base, queries):
    """Phase 14: the exact tier, the nine elementwise metrics, IVF with
    manhattan and LSH with l3, on the smoke's rows. Returns the phase's
    record."""
    import numpy as np
    from zebra_tpu_torch.ops import distances as D
    from zebra_tpu_torch.ops import scan as S

    device = torch.device("cuda", 0)
    rec = {}
    # the exact tier through the facade
    path = os.path.join(tmp, "exact.zebra")
    db = zt.Database.create(path, zt.DatabaseConfig(dim=DIM, index=zt.IndexOptions.tier("exact")))
    t0 = time.perf_counter()
    ids = db.insert_vectors(base)
    insert_s = time.perf_counter() - t0
    idx = db.index
    st = idx.state
    print(f"exact tier: {type(idx).__name__}, index_type {idx.options.index_type}, slab "
          f"{st.vectors.dtype} {tuple(st.vectors.shape)}, precision "
          f"{idx.options.exact_precision}; durable insert of {len(ids)} rows in {insert_s:.2f} s "
          f"(host clock; durability {db.config.durability})")
    check(idx.options.index_type == "flat" and st.vectors.dtype == torch.float32
          and len(db) == base.shape[0], "the exact tier must hold every row in an f32 slab")
    rec.update(insert_s=insert_s, settle_s=[settle(db, "exact ", "after the insert")])
    q = queries[:FLAT_QUERIES]
    qt = torch.from_numpy(q).to(device)
    arrays = idx.search_arrays(q, 10)
    top64 = exact64_topk(torch, "cosine", st.vectors, st.valid, qt, 10)
    differ, gap = hold_exact(torch, "cosine", st.vectors, arrays[1], qt, top64)
    flat_ms = time_ms(torch, lambda: idx._query_device(qt, 10, False), 5)
    live = int(st.valid.sum())
    flops = 2.0 * FLAT_QUERIES * live * DIM
    flat_bound, flat_by = bound_ms(float(live * (DIM * 4 + 1) + qt.numel() * 4
                                         + FLAT_QUERIES * 10 * 12), flops, PEAK_F32)
    print(f"exact tier search_arrays top-10 of {FLAT_QUERIES} held-out queries against the f64 "
          f"scan: every rank within {TIE_TOL} (largest gap {gap:.3g}); {differ} ranks hold "
          f"another id, all f64 ties; device time {flat_ms:.3f} ms per {FLAT_QUERIES} queries "
          f"over {st.vectors.shape[0]} slots, {live} live (CUDA events; {flops / 1e12:.2f} "
          f"TFLOP, bound {flat_bound:.3f} ms by {flat_by}, "
          f"{flat_bound / flat_ms:.3f} of it)")
    low = TB.brute_force(st, qt, 10, metric="cosine", precision="default")
    low_ms = time_ms(torch, lambda: TB.brute_force(st, qt, 10, metric="cosine",
                                                   precision="default"), 5)
    hi_slots = torch.from_numpy(arrays[1]).to(device)
    agree = float((low[1][:, :, None] == hi_slots[:, None, :]).any(-1).float().mean())
    print(f"exact tier, exact_precision=\"default\" (bf16 operands, f32 accumulator on the "
          f"tensor cores): {low_ms:.3f} ms per {FLAT_QUERIES} queries (CUDA events); top-10 "
          f"agreement with \"highest\" {agree:.4f}")
    pick = np.linspace(0, base.shape[0] - 1, 1024).astype(np.int64)
    self_rate = float(np.mean([r[0][0] == ids[i] for r, i in zip(db.query(base[pick], 1), pick)]))
    gone = [ids[i] for i in pick[:100]]
    db.remove(gone)
    back = {i for row in db.query(base[pick[:100]], 10) for i, _ in row} & set(gone)
    want = db.query(q[:256], 10)
    db.save()
    db.close()
    del idx, st
    db = zt.Database.open(path)
    same = db.query(q[:256], 10) == want
    print(f"exact tier: self-retrieval {self_rate:.4f} over 1024 rows; {len(gone)} removed, "
          f"{len(back)} returned again; save, close, reopen: same top-10 for 256 queries: {same}")
    check(self_rate == 1.0 and not back and same and len(db) == base.shape[0] - len(gone),
          "the exact tier lost a row, returned a removed one or changed across a reopen")
    rec.update(ms=flat_ms, bound_ms=flat_bound, default_ms=low_ms, default_agreement=agree,
               differing_ranks=differ)
    st = db.index.state
    n = int(st.valid.sum())
    # the occupied slots, rounded up to the scan's 8192-row chunk (the
    # slab's capacity is the next power of two past twice the rows)
    w_len = -(-db.index._next_slot // 8192) * 8192

    # the nine elementwise metrics through ops.scan.exact_scan on the same slab
    qm = qt[:METRIC_QUERIES]
    pairs = max(1, D.ELEMENTWISE_BYTES // (4 * DIM))
    q_chunks = -(-METRIC_QUERIES // max(1, min(METRIC_QUERIES, pairs // min(8192, pairs))))
    metrics = {}
    for metric in ELEMENTWISE:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        got = S.exact_scan(st.vectors, st.valid, qm, 10, metric=metric, w_len=w_len)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        differ, gap = hold_exact(torch, metric, st.vectors, got[1], qm, exact64_topk(
            torch, metric, st.vectors[:w_len], st.valid[:w_len], qm, 10))
        b, by = bound_ms(float(q_chunks * n * DIM * 4 + n),
                         float(ELEMENT_OPS[metric] * METRIC_QUERIES * n * DIM), PEAK_F32)
        metrics[metric] = {"ms": ms, "bound_ms": b, "bound_by": by, "differing_ranks": differ,
                           "gap": gap}
        print(f"elementwise {metric}: exact_scan top-10 of {METRIC_QUERIES} queries over "
              f"{n} live rows in the first {w_len} slots: {ms:.3f} ms (one run, CUDA events); "
              f"bound {b:.3f} ms by {by} (the slab read "
              f"once per query chunk, {q_chunks} chunks; {ELEMENT_OPS[metric]} f32 operations "
              f"an element), {b / ms:.4f} of it; against the f64 scan: every rank within "
              f"{TIE_TOL} (largest gap {gap:.3g}), {differ} ranks another id")
    rec["metrics"] = metrics
    db.close()
    del db, st, arrays, top64, low
    torch.cuda.empty_cache()
    shutil.rmtree(path + ".d", ignore_errors=True)

    # IVF at the defaults with manhattan: cells by sql2, the block re-rank
    path = os.path.join(tmp, "manhattan.zebra")
    R.LAUNCHES = 0
    R.LAUNCHES_BY_FORM.clear()
    V.EAGER_LARGE_K = 0
    db = zt.Database.create(path, zt.DatabaseConfig(dim=DIM, metric="manhattan"))
    t0 = time.perf_counter()
    ids = db.insert_vectors(base)
    insert_s = time.perf_counter() - t0
    rec["manhattan_settle_s"] = settle(db, "manhattan ", "after the insert")
    idx = db.index
    st = idx.state
    qi = queries[:IVF_METRIC_QUERIES]
    qit = torch.from_numpy(qi).to(device)
    approx = idx.search_arrays(qi, 10)[1]
    exact = V.brute_force(st, qit, 10, metric="manhattan")[1].cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))
    ivf_ms = time_ms(torch, lambda: idx._query_device(qit, 10, False), 3)
    rows = idx.search(base[pick], 1)
    own = [r[0][0] == ids[i] for r, i in zip(rows, pick)]
    misses = elementwise_misses(torch, V, idx, base, pick, ids, rows, own)
    print(f"IVF manhattan (defaults: {idx.options.dtype} refine={idx.options.refine}, "
          f"P={idx.options.resolved_probes()}, K={st.num_clusters}, C={st.cluster_capacity}; "
          f"cells by {idx._cell_metric}): insert {insert_s:.2f} s; recall@10 {recall:.4f} over "
          f"{IVF_METRIC_QUERIES} held-out queries against ivf.brute_force; self-retrieval "
          f"{float(np.mean(own)):.4f} over 1024 rows ({misses} misses, each explained); one "
          f"device query of {IVF_METRIC_QUERIES} {ivf_ms:.3f} ms (CUDA events); kernel 1 "
          f"launches {R.LAUNCHES} {dict(R.LAUNCHES_BY_FORM)}, eager fallbacks counted "
          f"{V.EAGER_LARGE_K}")
    check(recall >= MIN_RECALL, f"IVF manhattan recall@10 {recall} < {MIN_RECALL}")
    check(R.LAUNCHES == 0 and not R.LAUNCHES_BY_FORM,
          "an elementwise metric must take the block path, never kernel 1")
    rec.update(manhattan_insert_s=insert_s, manhattan_recall=recall,
               manhattan_self=float(np.mean(own)), manhattan_ms=ivf_ms)
    db.close()
    del db, idx, st
    torch.cuda.empty_cache()
    shutil.rmtree(path + ".d", ignore_errors=True)

    # LSH with l3: the card against the CPU on the same saved index
    path = os.path.join(tmp, "l3.zebra")
    db = zt.Database.create(path, zt.DatabaseConfig(
        dim=DIM, metric="l3", index=zt.IndexOptions(index_type="lsh")))
    rows_l3 = base[:LSH_METRIC_ROWS]
    ids = db.insert_vectors(rows_l3)
    settle(db, "l3 ", "after the insert")
    db.save()
    ql = queries[:METRIC_QUERIES]
    t0 = time.perf_counter()
    card = db.index.search_arrays(ql, 10)
    card_s = time.perf_counter() - t0
    db.close()
    host = zt.Database.open(path, device="cpu")
    t0 = time.perf_counter()
    cpu = host.index.search_arrays(ql, 10)
    cpu_s = time.perf_counter() - t0
    stored = host.index.state.vectors
    qc = torch.from_numpy(ql)
    d_card, d_cpu = (dist64(torch, "l3", qc.double()[:, None, :],
                            stored[torch.from_numpy(r[1])].double()) for r in (card, cpu))
    gap = float(((d_card - d_cpu).abs() / (1.0 + d_cpu.abs())).max())
    differ = int((card[1] != cpu[1]).sum())
    err = float(np.abs(card[0] - cpu[0]).max())
    print(f"LSH l3 ({LSH_METRIC_ROWS} rows, {METRIC_QUERIES} queries, saved on the card, opened "
          f"on the CPU): the card's top-10 against the CPU's: {differ} ranks hold another id "
          f"(largest f64 gap {gap:.3g} <= {TIE_TOL}), max abs distance difference {err:.3g}; "
          f"search_arrays {card_s * 1e3:.1f} ms on the card, {cpu_s * 1e3:.1f} ms on the CPU "
          f"(host clock)")
    check(np.array_equal(card[2], cpu[2]) and gap <= TIE_TOL
          and np.allclose(card[0], cpu[0], rtol=1e-5, atol=1e-5),
          "LSH l3 on the card differs from the CPU run of the same index")
    host.close()
    rec.update(l3_differing_ranks=differ, l3_max_err=err)
    return rec


def elementwise_misses(torch, V, idx, base, pick, ids, rows, own):
    """Self-retrieval misses of an IVF index with an elementwise metric:
    each passes only as a property of the data or of the index's design:
    the returned row at least as near as the row itself in f64 (within
    TIE_TOL), or the row spilled out of its nearest cell by sql2 (the cell
    metric), or held in the spare. Returns the number of misses."""
    import numpy as np

    st, metric = idx.state, idx.metric
    P = idx.options.resolved_probes()
    bad = 0
    miss = [b for b, ok in enumerate(own) if not ok]
    for b in miss:
        i = int(pick[b])
        q = torch.from_numpy(base[i : i + 1]).to(idx.device)
        slot_own = idx._id_to_slot.get(ids[i])
        slot_got = idx._id_to_slot.get(rows[b][0][0])
        recon = idx._take_rows(np.array([slot_own, slot_got])).double()
        d_own, d_got = dist64(torch, metric, q.double(), recon).tolist()
        probes = V.select_probes(st, q, P, "sql2").tolist()[0]
        placed = V._cell_choice(q, st.centroids, "sql2",
                                min(idx.options.spill, st.num_clusters)).tolist()[0]
        cell = slot_own // st.cluster_capacity if slot_own < st.spare_start else None
        spilled = cell is None or (cell in placed and placed.index(cell) > 0)
        nearer = d_got <= d_own + TIE_TOL * (1 + abs(d_own))
        print(f"  row {i}: returned slot {slot_got} at f64 {d_got:.9g} vs own slot {slot_own} "
              f"at {d_own:.9g}; own cell {cell} (probes {probes}, placement order {placed})")
        bad += not (nearer or spilled)
    check(not bad, f"{bad} rows lost their own id to a farther row in their own probed cell")
    return len(miss)


def draw_image(i: int):
    """Synthetic photo ``i`` as ``[h, w, 3]`` uint8: a seeded size around
    320 x 240, a two-colour gradient at a seeded angle and 3-7 filled
    rectangles."""
    import numpy as np

    rng = np.random.default_rng([SEED, 15, i])
    w, h = int(rng.integers(280, 361)), int(rng.integers(200, 281))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ang = rng.random() * 2 * np.pi
    t = (xx * np.cos(ang) + yy * np.sin(ang)) / (w + h) + 0.5
    c0, c1 = rng.random(3) * 255, rng.random(3) * 255
    img = c0 + (c1 - c0) * t[..., None]
    for _ in range(int(rng.integers(3, 8))):
        x0, x1 = np.sort(rng.integers(0, w, 2))
        y0, y1 = np.sort(rng.integers(0, h, 2))
        img[y0 : y1 + 1, x0 : x1 + 1] = rng.random(3) * 255
    return np.clip(img, 0, 255).astype(np.uint8)


def make_image(i: int) -> bytes:
    """Image ``i`` as JPEG bytes (quality 90). Module level, for a spawned
    worker pool."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(draw_image(i)).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def make_clip(i: int, samples: int = AUDIO_SAMPLES, stream: int = 16):
    """Synthetic clip ``i``: ``samples`` of 16 kHz mono 16-bit PCM (2 s by
    default), 1-3 tones (60 Hz - 7.7 kHz) and, for half the clips, a chirp
    across the clip, under a slow amplitude envelope, with a little noise;
    int16 numpy. ``stream`` keeps the draws of two sets apart."""
    import numpy as np

    rng = np.random.default_rng([SEED, stream, i])
    t = np.arange(samples) / AUDIO_RATE
    x = np.zeros(samples)
    for _ in range(int(rng.integers(1, 4))):
        f = 60.0 * 2 ** (rng.random() * 7)
        x += rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * f * t + rng.random() * 2 * np.pi)
    if rng.random() < 0.5:
        f0, f1 = 60.0 * 2 ** (rng.random(2) * 7)
        sweep = 2.0 * samples / AUDIO_RATE
        x += rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / sweep))
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 3.0) * t + rng.random() * 2 * np.pi)
    x += rng.normal(0.0, 0.01, samples)
    x *= 0.9 / max(float(np.abs(x).max()), 1e-9)
    return np.round(x * 32767).astype(np.int16)


def make_wide_wav(i: int) -> bytes:
    """Clip ``i`` of the set that fills the tower's 30 s window, as WAV."""
    return wav_bytes(make_clip(i, WIDE_SAMPLES, 17))


def wav_bytes(pcm) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(AUDIO_RATE)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def flac_bytes(pcm) -> bytes:
    """The clip through the repository's independent FLAC encoder
    (``tests/flac_encoder.py``, loaded by its path: an installed package
    named ``tests`` may shadow the repository's; fixed order-2 prediction,
    4096-sample blocks)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("flac_encoder", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "flac_encoder.py"))
    enc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(enc)
    return enc.encode_flac(pcm.astype("int64"), rate=AUDIO_RATE, bps=16, blocksize=4096,
                       kind="fixed", order=2)


def media_availability() -> None:
    """What the card's machine has for the media decoders, printed; fails
    without Pillow, which the image path decodes with."""
    import ctypes.util
    import importlib.util

    from zebra_tpu_torch.native import av, codecs, flac

    have_pil = importlib.util.find_spec("PIL") is not None
    print(f"media libraries: Pillow {have_pil}; libmpg123 {codecs._libmpg123() is not None} "
          f"({ctypes.util.find_library('mpg123')}); libvorbisfile "
          f"{codecs._libvorbisfile() is not None} ({ctypes.util.find_library('vorbisfile')}); "
          f"the libav shim builds and loads: {av.available()}; the FLAC decoder builds: "
          f"{flac.available()}")
    check(have_pil, "Pillow is not installed: the image path cannot decode its JPEGs")


def path_entry(label, by_form, path_recs, err):
    """Kernel 1's JSON entry for one document path: the numbers of the form
    the path launched most, on the path's own probes, and every form's."""
    source = {"query": "zebra_tpu_torch/csrc/ivf_rerank.cu",
              "cluster": "zebra_tpu_torch/csrc/ivf_rerank_cluster.cu"}
    main_form = max(by_form, key=by_form.get).split("/")[1]
    r = path_recs[f"int8+residual/{main_form}"]
    return {"name": "ivf_rerank", "path": label, "route": "cuda", "source": source[main_form],
            "replaces": "zebra_tpu/ops/pallas_ivf.py:72", "launches": sum(by_form.values()),
            "max_abs_err": max(err, *(x["max_abs_err"] for x in path_recs.values())),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "forms": {k: {"source": source[k.split("/")[1]], "launches": by_form.get(k, 0), **v}
                      for k, v in path_recs.items()}}


def document_path(torch, zt, V, R, IC, db, cpu_model, docs, held, tag,
                  remove=MEDIA_REMOVE, dup=MEDIA_DUP_ROWS, require_spread=None):
    """Phase 15's checks of one media database at its defaults, as phase 12
    holds the text path: the card's tower against the CPU's on 256
    documents (<= MEDIA_TOWER_ATOL), one document bitwise equal alone, at
    another row and in another call; ``insert_documents`` with its stage
    table; ``query_documents`` of the held-out documents (QPS, the returned
    bytes equal the inserted bytes); self-retrieval of 1024 documents (1.0,
    or each miss classified by ``fault_c_report``, whose own launches are
    kept out of the path's count) and the share of the cells their probes
    reach; removes (ids and blobs gone); the ``dup`` rows' planted copies
    removed exactly by ``deduplicate``; save, close, reopen (same answers);
    the stored rows queried at once (kernel 1 by form); the facade's top-10
    against kernel 1's plain version on the same probes; both forms on the
    path's probes. ``require_spread`` (the audio databases): True requires
    the probed share to reach MIN_PROBED_SHARE; False names the
    self-retrieval and parity as not counted where it does not (and lets
    probe selection's stage 1 differ by f64 ties). Returns kernel 1's
    launches by form, the path's kernel records, the parity error and the
    record."""
    import numpy as np
    from zebra_tpu_torch import profiling as P

    model = db.model
    n = len(docs)
    card = model.embed_documents(docs[:256])
    t0 = time.perf_counter()
    host = cpu_model.embed_documents(docs[:256])
    cpu_s = time.perf_counter() - t0
    same_weights = all(torch.equal(a.cpu(), b) for a, b in zip(
        model.tower().state_dict().values(), cpu_model.tower().state_dict().values()))
    tower_err = float(np.abs(card - host).max())
    alone = model.embed_documents([docs[77]])[0]
    in_100 = model.embed_documents(docs[:100])[77]
    in_38 = model.embed_documents(docs[40:78])[37]
    bitwise = all(np.array_equal(alone.view(np.uint32), v.view(np.uint32)) for v in (in_100, in_38))
    print(f"{tag}tower ({model.mode}, batch {model.batch_size}): same weights as the CPU tower: "
          f"{same_weights}; card vs CPU on 256 documents: max abs err {tower_err:.3g} (<= "
          f"{MEDIA_TOWER_ATOL}; the CPU took {cpu_s:.2f} s); one document alone, at row 77 of "
          f"100 and at row 37 of 38: bitwise equal {bitwise}")
    check(same_weights and tower_err <= MEDIA_TOWER_ATOL, f"{tag}the card's tower differs")
    check(bitwise, f"{tag}the embedding depends on the batch")
    R.LAUNCHES = 0
    R.LAUNCHES_BY_FORM.clear()
    V.EAGER_LARGE_K = 0
    P.GLOBAL_STATS.ops.clear()
    t0 = time.perf_counter()
    ids = db.insert_documents(docs)
    insert_s = time.perf_counter() - t0
    stages = db.stats.summary()
    st = db.index.stats()
    split = ", ".join(f"{k} {stages[k]['seconds']:.2f} s" for k in
                      ("insert.embed", "insert.blobs", "insert.wal", "insert.index") if k in stages)
    print(f"{tag}insert_documents: {n} documents in {insert_s:.2f} s = {n / insert_s:.0f} "
          f"documents/s (host clock): {split}; clusters={st['clusters']}, "
          f"C={st['cluster_capacity']}, spare_used={st['spare_used']}, overflow={st['overflow']}")
    check(len(db) == n and st["overflow"] == 0, f"{tag}documents lost on insert")
    check({"insert.embed", "insert.blobs", "insert.wal", "insert.index"} <= set(stages),
          f"{tag}the insert stage table lacks a stage")
    rec = {"insert_s": insert_s, "stages": stages, "tower_err": tower_err,
           "settle_s": [settle(db, tag, "after the insert")]}
    doc_of = dict(zip(ids, docs))
    q_before = stages.get("query.embed", {}).get("seconds", 0.0)
    t0 = time.perf_counter()
    found = {}
    for s in range(0, len(held), 256):
        found.update({s + q: v for q, v in db.query_documents(held[s : s + 256], 10).items()})
    qs = time.perf_counter() - t0
    q_embed = db.stats.summary()["query.embed"]["seconds"] - q_before
    print(f"{tag}query_documents: {len(held)} held-out documents in batches of 256, k=10: "
          f"{len(held) / qs:.0f} QPS, of which query.embed {q_embed:.2f} s of {qs:.2f} s")
    check(len(found) == len(held) and all(len(v) == 10 for v in found.values()),
          f"{tag}every held-out query must return 10 documents")
    check(all(doc_of[i] == d for v in found.values() for i, d in v.items()),
          f"{tag}a returned document differs from the inserted bytes of its id")
    rec.update(query_qps=len(held) / qs, query_embed_s=q_embed)
    pick = np.linspace(0, n - 1, 1024).astype(np.int64)
    picked = [docs[i] for i in pick]
    hits = db.query_documents(picked, number_of_results=1)
    self_rate = float(np.mean([hits[q] == {ids[i]: docs[i]} for q, i in enumerate(pick)]))
    # the diagnosis below launches kernel 1 itself: the path's count is kept
    # as it stood before it
    count = R.LAUNCHES, dict(R.LAUNCHES_BY_FORM)
    qv = model.embed_documents(picked)
    idx = db.index
    K = idx.state.num_clusters
    probed = V.select_probes(idx.state, torch.from_numpy(qv).to(idx.device),
                             idx.options.resolved_probes(), idx.metric, idx.options.probe_sel)
    share = torch.unique(probed).numel() / K
    spread = share >= MIN_PROBED_SHARE
    misses = 0
    if self_rate < 1.0:
        misses = fault_c_report(torch, V, R, IC, db, qv, db.query(qv, 10),
                                [ids[i] for i in pick], picked, range(len(pick)), tag)
    R.LAUNCHES = count[0]
    R.LAUNCHES_BY_FORM.clear()
    R.LAUNCHES_BY_FORM.update(count[1])
    counted = "" if spread or require_spread is None else (
        f"; NOT COUNTED: the queries probe {share:.3f} of the cells (< {MIN_PROBED_SHARE}), "
        f"every answer an f64 tie of the others, so neither this nor the parity below can "
        f"fail a wrong answer here")
    print(f"{tag}self-retrieval: {self_rate:.4f} over 1024 inserted documents ({misses} misses, "
          f"each classified); their probes reach {torch.unique(probed).numel()} of {K} cells "
          f"({share:.3f}){counted}")
    check(spread or not require_spread, f"{tag}the queries probe {share:.3f} of the cells "
          f"(< {MIN_PROBED_SHARE}): the data are too crowded for the checks to count")
    gone = ids[remove]
    db.remove(gone)
    back = {i for v in db.query_documents(docs[remove], 10).values() for i in v} & set(gone)
    blobs_left = db._docs.read_many(gone)
    copies = db.insert_documents(docs[dup])
    before = len(db)
    t0 = time.perf_counter()
    db.deduplicate()
    dedup_s = time.perf_counter() - t0
    removed = before - len(db)
    left = sum(i in db.index for i in copies)
    print(f"{tag}remove: {len(gone)} ids removed; returned again {len(back)}; blobs left "
          f"{len(blobs_left)}; deduplicate: {removed} of {len(copies)} planted copies removed "
          f"({left} left) in {dedup_s:.3f} s")
    check(not back and not blobs_left, f"{tag}a removed id came back or kept its blob")
    check(removed == len(copies) and left == 0 and not db._docs.read_many(copies)
          and all(i in db.index for i in ids[dup]),
          f"{tag}deduplicate did not remove exactly the planted copies")
    probe = held[:256]
    want = db.query_documents(probe, 10)
    rec["settle_s"].append(settle(db, tag, "before the save"))
    path = db.path
    db.save()
    db.close()
    db = zt.Database.open(path)
    got = db.query_documents(probe, 10)
    print(f"{tag}save, close, reopen: same top-10 and blobs for 256 held-out documents: "
          f"{got == want}; live documents {len(db)}")
    check(got == want and len(db) == n - len(gone), f"{tag}the reopened database differs")
    idx = db.index
    live = np.array(sorted(idx._id_to_slot.get(i) for i in ids if i in idx), np.int64)
    big = idx._take_rows(live).float().cpu().numpy()
    big_rows = db.query(big, 10)
    launches, by_form = R.LAUNCHES, dict(R.LAUNCHES_BY_FORM)
    print(f"{tag}db.query of the {len(big)} stored rows at once: self at rank 1 for "
          f"{float(np.mean([r[0][1] <= 1e-5 for r in big_rows])):.4f}; kernel 1 launches over "
          f"the path {launches} {by_form}; eager fallbacks {V.EAGER_LARGE_K}")
    check(launches > 0 and sum(by_form.values()) == launches and V.EAGER_LARGE_K == 0,
          f"{tag}the path must run kernel 1")
    st, metric, probes_n = idx.state, idx.metric, idx.options.resolved_probes()
    qh = model.embed_documents(held)
    qt = torch.from_numpy(qh).to(idx.device)
    arrays = idx.search_arrays(qh, 10)
    facade = (torch.from_numpy(arrays[0]).to(idx.device),
              torch.from_numpy(arrays[1]).to(idx.device).long(),
              torch.from_numpy(arrays[2]).to(idx.device))
    probes = V.select_probes(st, qt, probes_n, metric, idx.options.probe_sel)
    plain = R.ivf_rerank_reference(st, qt, probes, 10, metric, scan_residual=True)
    if idx._spare_used > 0:
        plain = V._merge_spare(st, qt, *plain, 10, metric, True)
    agree, err, swaps, gap = hold(torch, facade, plain, slab_d64(torch, st, qt, metric, True),
                                  min_agree=0.0)
    print(f"{tag}parity: the facade's top-10 of the {len(held)} held-out documents against "
          f"kernel 1's plain version on the same probes (P={probes_n}, {metric}): slot "
          f"agreement {agree:.6f}, max abs err {err:.3g}; {swaps} differing ranks, all ties "
          f"(largest f64 gap {gap:.3g} <= {TIE_TOL}){'; not counted' if counted else ''}")
    path_recs = probe_path_stages(torch, V, R, IC, db, big, True, tag,
                                  crowded=require_spread is False)
    rec.update(self=self_rate, misses=misses, dedup_s=dedup_s, launches=by_form,
               probed_share=share, counted=not counted)
    db.close()
    return by_form, path_recs, err, rec


def media_path(torch, zt, V, R, IC, tmp):
    """Phase 15: the image and audio document paths at ``defaults.image_db``
    and ``defaults.audio_db`` on the card, the full ViT encoder registered as
    a custom model, and the CLI. Returns kernel 1's entries and the record."""
    import contextlib
    import io
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from zebra_tpu_torch.cli import main as cli_main
    from zebra_tpu_torch.models import audio as MA
    from zebra_tpu_torch.models import image as MI
    from zebra_tpu_torch.models.base import register_model

    media_availability()
    entries, rec = [], {}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(os.cpu_count(), mp_context=spawn) as pool:
        t0 = time.perf_counter()
        clips = list(pool.map(make_clip, range(AUDIO_DOCS + AUDIO_QUERIES), chunksize=256))
        flacs = pool.map(flac_bytes, clips[:AUDIO_FLAC], chunksize=8)
        wide = pool.map(make_wide_wav, range(WIDE_DOCS + WIDE_QUERIES), chunksize=16)
        images = list(pool.map(make_image, range(IMAGE_DOCS + IMAGE_QUERIES), chunksize=256))
        flacs, wide = list(flacs), list(wide)
    print(f"media data: {len(images)} synthetic JPEG images (mean "
          f"{np.mean([len(b) for b in images]) / 1024:.1f} KiB), {len(clips)} clips of "
          f"{AUDIO_SAMPLES / AUDIO_RATE:.0f} s at {AUDIO_RATE} Hz and their first {len(flacs)} "
          f"as FLAC, {len(wide)} clips of {WIDE_SAMPLES / AUDIO_RATE:.0f} s as WAV in "
          f"{time.perf_counter() - t0:.2f} s ({os.cpu_count()} spawned workers)")

    # images: defaults.image_db (embeddings_mean, cosine, IVF at the defaults)
    db = zt.defaults.image_db(os.path.join(tmp, "image.zebra"))
    cpu_model = MI.VitImageModel(device="cpu")
    status = db.model_status()
    print(f"image model_status: {json.dumps(status)}")
    check(db.config.dim == 768 and db.config.metric == "cosine", "the image defaults changed")
    tower = db.model.tower()
    px = db.model.pixels(images[:db.model.batch_size])
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: tower(px), 20)
    flops = tower.flops(db.model.batch_size)
    print(f"image tower forward ({db.model.mode}), a padded batch of {db.model.batch_size} "
          f"(CUDA events, f32, TF32 off): {fwd_ms:.3f} ms; {flops / 1e9:.1f} GFLOP, f32 bound "
          f"{flops / PEAK_F32 * 1e3:.3f} ms")
    by_form, recs, err, rec["image"] = document_path(
        torch, zt, V, R, IC, db, cpu_model, images[:IMAGE_DOCS], images[IMAGE_DOCS:],
        "image ")
    rec["image"]["forward_ms"] = fwd_ms
    entries.append(path_entry("image documents (D=768, cosine, P=2, k=10)", by_form, recs,
                              err))

    # the full encoder, registered as a custom model
    register_model("vit-base-patch16-224-cls", lambda: MI.VitImageModel(mode="encoder_cls"))
    enc_db = zt.Database.create(os.path.join(tmp, "encoder.zebra"), zt.DatabaseConfig(
        dim=768, metric="cosine", model="vit-base-patch16-224-cls"))
    model = enc_db.model
    docs = images[:ENCODER_DOCS]
    t0 = time.perf_counter()
    enc_ids = enc_db.insert_documents(docs)
    enc_s = time.perf_counter() - t0
    tower = model.tower()
    px = model.pixels(docs[: model.batch_size])
    with torch.inference_mode():
        enc_ms = time_ms(torch, lambda: tower(px), 10)
    flops = tower.flops(model.batch_size)
    enc_bound = flops / PEAK_F32 * 1e3
    card = model.embed_documents(docs[:64])
    cpu_enc = MI.VitImageModel(mode="encoder_cls", device="cpu")
    enc_err = float(np.abs(card - cpu_enc.embed_documents(docs[:64])).max())
    hits = enc_db.query_documents(docs[:256], 1)
    enc_self = float(np.mean([hits[q] == {enc_ids[q]: docs[q]} for q in range(256)]))
    print(f"encoder_cls database (register_model, {len(tower.blocks)} blocks): insert of "
          f"{ENCODER_DOCS} images {enc_s:.2f} s; forward of a padded batch of "
          f"{model.batch_size} {enc_ms:.3f} ms (CUDA events; {flops / 1e12:.3f} TFLOP, f32 "
          f"bound {enc_bound:.3f} ms, {enc_bound / enc_ms:.3f} of it); card vs CPU on 64 "
          f"images: max abs err {enc_err:.3g} (<= {MEDIA_TOWER_ATOL}); self-retrieval "
          f"{enc_self:.4f} over 256")
    check(enc_err <= MEDIA_TOWER_ATOL and len(enc_db) == ENCODER_DOCS,
          "the encoder tower on the card differs from the CPU's")
    rec["encoder"] = {"insert_s": enc_s, "forward_ms": enc_ms, "bound_ms": enc_bound,
                      "err": enc_err, "self": enc_self}
    enc_db.close()
    del enc_db, model, tower, px, cpu_enc
    torch.cuda.empty_cache()

    # audio: defaults.audio_db (the spectrogram and the tower on the card)
    wavs = [wav_bytes(c) for c in clips]
    db = zt.defaults.audio_db(os.path.join(tmp, "audio.zebra"))
    print(f"audio model_status: {json.dumps(db.model_status())}")
    model = db.model
    host = np.stack([MA.pad_samples(MA.audio_to_data(w)[0]) for w in wavs[:256]])
    spec_card = MA.spectrogram(torch.from_numpy(host).to(model.device)).cpu()
    spec_err = float((spec_card - MA.spectrogram(torch.from_numpy(host))).abs().max())
    twins = model.embed_documents(flacs)
    first = model.embed_documents(wavs[:AUDIO_FLAC])
    twin_equal = np.array_equal(twins.view(np.uint32), first.view(np.uint32))
    print(f"audio: spectrogram card vs CPU on 256 clips: max abs err {spec_err:.3g} (<= "
          f"{SPECTROGRAM_ATOL}); {len(flacs)} FLAC twins (mean "
          f"{np.mean([len(f) for f in flacs]) / 1024:.1f} KiB against "
          f"{len(wavs[0]) / 1024:.1f} KiB WAV) embed bitwise as their WAV clips: "
          f"{twin_equal}")
    check(spec_err <= SPECTROGRAM_ATOL, "the card's spectrogram differs from the CPU's")
    check(twin_equal, "a FLAC clip embeds other than its WAV twin")
    cpu_model = MA.VitAudioModel(device="cpu")
    by_form, recs, err, rec["audio"] = document_path(
        torch, zt, V, R, IC, db, cpu_model, wavs[:AUDIO_DOCS], wavs[AUDIO_DOCS:], "audio ",
        require_spread=False)
    rec["audio"]["spectrogram_err"] = spec_err
    entries.append(path_entry("audio documents, 2 s clips (D=768, cosine, P=2, k=10)",
                              by_form, recs, err))

    # audio again, on clips that fill the 30 s window: spread enough to count
    db = zt.defaults.audio_db(os.path.join(tmp, "audio_wide.zebra"))
    by_form, recs, err, rec["audio_wide"] = document_path(
        torch, zt, V, R, IC, db, cpu_model, wide[:WIDE_DOCS], wide[WIDE_DOCS:], "audio 30 s ",
        remove=WIDE_REMOVE, dup=WIDE_DUP_ROWS, require_spread=True)
    entries.append(path_entry("audio documents, 30 s clips (D=768, cosine, P=2, k=10)",
                              by_form, recs, err))
    del wide

    # the CLI in this process, on the card
    files = []
    for i, data in enumerate(images[:2] + wavs[:1]):
        p = os.path.join(tmp, f"cli{i}.{'wav' if i == 2 else 'jpg'}")
        with open(p, "wb") as f:
            f.write(data)
        files.append(p)

    def cli(*argv):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(list(argv))
        check(rc == 0, f"cli {' '.join(argv[2:4])} exited {rc}: {err.getvalue()[-2000:]}")
        return out.getvalue(), time.perf_counter() - t0

    img_db, aud_db = os.path.join(tmp, "cli_i.zebra"), os.path.join(tmp, "cli_a.zebra")
    out, t_ins = cli("--database-path", img_db, "image", "insert", *files[:2])
    check("Inserted 2 image document(s) (768-dimensional" in out, f"cli image insert: {out!r}")
    out, t_q = cli("--database-path", img_db, "image", "query", files[1], "--preview")
    sixel = "\x1bPq" in out and out.count("\x1b\\") == 1
    check(sixel, f"cli image query --preview wrote no sixel image: {out[:200]!r}")
    out, _ = cli("--database-path", aud_db, "audio", "insert", files[2])
    out, t_a = cli("--database-path", aud_db, "audio", "query", files[2], "--play")
    check("Query 0:" in out and ("playback unavailable" in out or "bytes" in out),
          f"cli audio query: {out!r}")
    print(f"media cli (in this process): image insert of 2 files {t_ins:.2f} s, image query "
          f"--preview {t_q:.2f} s (sixel written: {sixel}), audio query --play {t_a:.2f} s "
          f"({out.strip().splitlines()[-2].strip() if 'playback' in out else 'played'})")
    return entries, rec


#: phase 17's writer, run as its own process: it creates the database at the
#: library defaults on the card, inserts the rows in equal calls and, after
#: each call returns, appends the call's ids to ``acked.ids`` and fsyncs it.
#: Mode "b" removes KILL_REMOVE acknowledged ids after its 4th call (logged
#: to ``removed.ids``); mode "c" watches for the background log fold. Each
#: event is a line on stdout; the parent kills the writer (SIGKILL).
KILL_WRITER = r'''
import os
import sys
import threading
import time

import numpy as np

repo, path, rows_path, mode, calls, remove_n = sys.argv[1:7]
sys.path.insert(0, repo)
import zebra_tpu_torch as zt  # noqa: E402

calls, remove_n = int(calls), int(remove_n)
rows = np.load(rows_path, mmap_mode="r")
per = rows.shape[0] // calls
db = zt.Database.create(path, zt.DatabaseConfig(dim=rows.shape[1]))


def say(msg):
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def durable(name, ids):
    with open(os.path.join(os.path.dirname(path), name), "ab") as f:
        f.write(b"".join(ids))
        f.flush()
        os.fsync(f.fileno())


def watch_fold():
    while True:
        t = db._fold_thread
        if t is not None and t.is_alive():
            say("fold running")
            return
        time.sleep(0.0005)


say(f"ready: span {db._insert_span_rows(per)} rows")
if mode == "c":
    threading.Thread(target=watch_fold, daemon=True).start()
acked = []
for c in range(calls):
    say(f"call {c} start")
    t0 = time.perf_counter()
    ids = db.insert_vectors(np.ascontiguousarray(rows[c * per:(c + 1) * per]))
    durable("acked.ids", ids)
    acked += ids
    say(f"call {c} acked {time.perf_counter() - t0:.3f}")
    if mode == "b" and c == 3:
        victims = acked[:: len(acked) // remove_n][:remove_n]
        db.remove(victims)
        durable("removed.ids", victims)
        say("removed")
        time.sleep(600)
say("fold never started" if mode == "c" and db._fold_thread is None else "calls done")
time.sleep(600)
'''


def read_ids(path: str) -> list[bytes]:
    """The whole 16-byte ids of a writer's side file (none if absent)."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        raw = f.read()
    return [raw[o : o + 16] for o in range(0, len(raw) - len(raw) % 16, 16)]


def drive_writer(proc, mode: str) -> dict:
    """Read writer ``mode``'s event lines and SIGKILL it at its point: (a)
    KILL_IN_CALL_SHARE of the previous call's seconds into call
    KILL_IN_CALL, (b) when its remove is acknowledged, (c) KILL_FOLD_DELAY_S
    after it sees the log fold start (or, when no fold started within the
    calls, after its last call). Returns its lines, the kill and how it
    ended."""
    ev = {"lines": [], "killed": None, "at": 0, "fold": None, "started": -1}
    last_s = 0.0
    watchdog = threading.Timer(KILL_CHILD_TIMEOUT_S, proc.kill)
    watchdog.start()
    try:
        # the lines the writer printed before it died are read to the end
        for line in proc.stdout:
            line = line.strip()
            ev["lines"].append(line)
            words = line.split()
            if line.startswith("call ") and words[2] == "start":
                ev["started"] = int(words[1])
            elif line.startswith("call ") and words[2] == "acked":
                last_s = float(words[3])
            if line in ("fold running", "fold never started"):
                ev["fold"] = line == "fold running"
            due = ((mode == "a" and line == f"call {KILL_IN_CALL} start")
                   or (mode == "b" and line == "removed")
                   or (mode == "c" and line in ("fold running", "fold never started")))
            if due and ev["killed"] is None:
                time.sleep(KILL_IN_CALL_SHARE * last_s if mode == "a" else
                           KILL_FOLD_DELAY_S if line == "fold running" else 0.0)
                ev["killed"], ev["at"] = line, len(ev["lines"])
                proc.kill()
    finally:
        watchdog.cancel()
        if ev["killed"] is None:
            proc.kill()
        proc.wait(timeout=60)
    ev["rc"] = proc.returncode
    return ev


def certified_top1(torch, idx, q, chunk: int = 4096):
    """The exact top-1 (cosine) of each row of ``q [n, D]`` among the live
    stored rows of ``idx``, with its f64 distance: ``(slots [n], d [n])``.
    A bf16 product of the unit vectors ranks every live row; the first is
    the exact top-1 wherever its f64 score beats the runner-up's bf16 score
    by KILL_BF16_ERR (no row's bf16 score is off by more), and the rows not
    so certified are scanned again in f64. Also returns how many were."""
    import numpy as np

    live = torch.from_numpy(idx._slot_ids.live_slots()).to(idx.device)
    x = idx._take_rows(live.cpu().numpy()).float()
    xn = x / x.norm(dim=1, keepdim=True).clamp(min=1e-30)
    xb = xn.to(torch.bfloat16)
    slots, dist, rescanned = [], [], 0
    for s in range(0, q.shape[0], chunk):
        qc = torch.from_numpy(np.ascontiguousarray(q[s : s + chunk])).to(idx.device)
        qn = qc / qc.norm(dim=1, keepdim=True).clamp(min=1e-30)
        score = torch.mm(qn.to(torch.bfloat16), xb.T, out_dtype=torch.float32)
        top = score.topk(min(2, x.shape[0]), dim=1)
        first = top.indices[:, 0]
        own = (qn.double() * xn[first].double()).sum(1)
        runner = top.values[:, 1].double() if x.shape[0] > 1 else torch.full_like(own, -2.0)
        unsure = torch.nonzero(own <= runner + KILL_BF16_ERR).flatten()
        del score, top
        for u in unsure.split(256):  # rare: scan those rows again in f64
            full = torch.cat([(qn[u].double() @ xn[c : c + chunk * 8].double().T)
                              for c in range(0, x.shape[0], chunk * 8)], 1)
            first[u] = full.argmax(1)
            own[u] = full.max(1).values
        rescanned += int(unsure.numel())
        slots.append(live[first])
        dist.append(1.0 - own)
    return torch.cat(slots).cpu().numpy(), torch.cat(dist).cpu().numpy(), rescanned


def kill_check(torch, V, R, IC, db, tag, rows, ev, writer_dir, span):
    """Phase 17's checks of one reopened database: every acknowledged
    insert live and its row's exact top-1 its own id within KILL_SELF_TOL,
    no acknowledged remove live, the rows of the call in flight present only
    as a prefix of whole spans (each exact), the length, and a query of
    KILL_QUERY acknowledged rows through kernel 1 (each its own id, a miss
    classified by ``fault_c_report``). Returns the record and the launches
    of that query."""
    import numpy as np

    idx = db.index
    per = KILL_ROWS // KILL_CALLS
    acked = read_ids(os.path.join(writer_dir, "acked.ids"))
    removed = read_ids(os.path.join(writer_dir, "removed.ids"))
    gone = set(removed)
    n = len(acked)
    # the call in flight: the last one started, its rows past the acknowledged
    call = ev["started"]
    flight = slice(n, (call + 1) * per) if call >= 0 and n < (call + 1) * per else slice(n, n)
    with db._lock.read():
        slot_of = [idx._id_to_slot.get(i) for i in acked]
        lost = [r for r, (i, sl) in enumerate(zip(acked, slot_of))
                if sl is None and i not in gone]
        returned = [i for i in removed if i in idx]
        keep = np.array([r for r in range(n) if acked[r] not in gone], np.int64)
        t0 = time.perf_counter()
        top, dist, rescanned = certified_top1(torch, idx, rows[keep])
        want = np.array([slot_of[r] if slot_of[r] is not None else -1 for r in keep])
        wrong = int((top != want).sum())
        far = float(dist.max()) if len(dist) else 0.0
        present = np.zeros(flight.stop - flight.start, bool)
        if len(present):
            ftop, fdist, more = certified_top1(torch, idx, rows[flight])
            rescanned += more
            own = set(np.asarray([sl for sl in slot_of if sl is not None]).tolist())
            present = (fdist <= KILL_SELF_TOL) & np.array([s not in own for s in ftop.tolist()])
        length = len(db)
        exact_s = time.perf_counter() - t0
    # the whole call in flight: its acknowledged head, then its present rows
    head = n - call * per if flight.stop > flight.start else 0
    whole = np.concatenate([np.ones(head, bool), present])
    m = int(whole.sum())
    prefix = bool(whole[:m].all()) and m % span == 0
    expect = n - len(removed) + int(present.sum())
    print(f"{tag}reopened: {n} acknowledged rows ({n // per} whole calls), {len(removed)} "
          f"acknowledged removes, the call in flight {call if flight.stop > flight.start else None}"
          f": {int(present.sum())} of its {len(present)} unacknowledged rows present, "
          f"{m // span if prefix else 'not'} whole spans of {span}; {len(lost)} acknowledged "
          f"rows lost, {wrong} whose exact top-1 is another row ({rescanned} rows scanned "
          f"again in f64; {exact_s:.2f} s), the farthest own row at cosine {far:.3g}; "
          f"{len(returned)} removed ids live; {length} live (expected {expect})")
    check(not lost and not wrong and far <= KILL_SELF_TOL,
          f"{tag}an acknowledged insert is lost or not exact after the kill")
    check(not returned, f"{tag}an acknowledged remove came back after the kill")
    check(prefix and (not len(present) or float(fdist[present].max(initial=0.0)) <= KILL_SELF_TOL),
          f"{tag}the call in flight is not a prefix of whole spans")
    check(length == expect, f"{tag}the reopened database holds {length} rows, not {expect}")

    # a query of acknowledged rows through kernel 1, once a retrain the
    # replay wanted has landed
    t0 = time.perf_counter()
    db.wait_for_retrain()
    wait_s = time.perf_counter() - t0
    pick = keep[np.linspace(0, len(keep) - 1, KILL_QUERY).astype(np.int64)]
    qv = np.ascontiguousarray(rows[pick])
    before = R.LAUNCHES
    res = db.query(qv, 10)
    launches = R.LAUNCHES - before
    own_ids = [acked[r] for r in pick]
    hits = sum(bool(row) and row[0][0] == i for row, i in zip(res, own_ids))
    leaked = sum(r[0] in gone for row in res for r in row)
    print(f"{tag}db.query of {KILL_QUERY} acknowledged rows (after {wait_s:.2f} s waiting for "
          f"the retrain the replay started; retrains {db._retrain_log}): {hits} return their "
          f"own id first, {leaked} removed ids returned; kernel 1 launched {launches} times")
    check(launches > 0, f"{tag}the reopened database's query did not launch kernel 1")
    check(not leaked, f"{tag}the query returned a removed id")
    if hits < KILL_QUERY:
        fault_c_report(torch, V, R, IC, db, qv, res, own_ids, [q.tobytes() for q in qv],
                       range(KILL_QUERY), tag=tag, detail=5,
                       accept=("nearer in f64", "a tie with the P-th probe", "spilled",
                               "dropped by stage 1's rounding"))
    return {"acked": n, "removed": len(removed), "in_flight_call": call if len(present) else None,
            "present": int(present.sum()), "spans": m // span, "live": length,
            "self": hits / KILL_QUERY, "launches": launches}, launches, qv


def kill_kernel_entry(torch, V, R, IC, db, qv, launches):
    """Kernel 1's JSON entry for phase 17: the form ``db.query`` took at
    B=KILL_QUERY on the reopened database's own probes, against its plain
    version (every differing rank an f64 tie) and timed beside it."""
    idx = db.index
    st, metric, P = idx.state, idx.metric, idx.options.resolved_probes()
    qt = torch.from_numpy(qv).to(idx.device)
    probes = V.select_probes(st, qt, P, metric, idx.options.probe_sel)
    form = "cluster" if IC.takes_cluster_form(qt.shape[0], P, st.dim, st.cluster_capacity,
                                              st.vectors.dtype, 10) else "query"
    want = R.ivf_rerank_reference(st, qt, probes, 10, metric, scan_residual=True)
    got = R.ivf_rerank(st, qt, probes, 10, metric, True)
    agree, err, swaps, gap = hold(torch, got, want, slab_d64(torch, st, qt, metric, True),
                                  min_agree=0.0)
    ms = time_ms(torch, lambda: R.ivf_rerank(st, qt, probes, 10, metric, True), 20)
    plain = time_ms(torch, lambda: R.ivf_rerank_reference(st, qt, probes, 10, metric,
                                                          scan_residual=True), 2)
    (bound, by), blocks, _ = probe_bound(torch, st, probes, qt.shape[0], 10, PEAK_F32, True)
    print(f"kill: ivf_rerank int8+residual {form} form on the reopened database's probes, "
          f"B={qt.shape[0]}: slot agreement {agree:.6f}, max abs err {err:.3g}, {swaps} differing "
          f"ranks, all ties (largest f64 gap {gap:.3g}); {ms:.3f} ms, plain {plain:.3f} ms, bound "
          f"{bound:.3f} ms ({by}), {blocks} distinct blocks")
    src = {"query": "zebra_tpu_torch/csrc/ivf_rerank.cu",
           "cluster": "zebra_tpu_torch/csrc/ivf_rerank_cluster.cu"}[form]
    return {"name": "ivf_rerank", "path": "kill and reopen (D=768, cosine, P=2, k=10)",
            "route": "cuda", "source": src, "replaces": "zebra_tpu/ops/pallas_ivf.py:72",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def kill_path(torch, zt, V, R, IC, tmp, base):
    """Phase 17: three writers on the card, each killed (SIGKILL) at its
    point with the pinned ring, the copy streams and the workers live, then
    each database reopened here on the card and checked (``kill_check``).
    Returns the phase's record and kernel 1's entry."""
    import numpy as np

    from zebra_tpu_torch.index.base import read_meta

    t_phase = time.perf_counter()
    rows = base[:KILL_ROWS]
    rows_path = os.path.join(tmp, "rows.npy")
    np.save(rows_path, rows)
    writer = os.path.join(tmp, "writer.py")
    with open(writer, "w") as f:
        f.write(KILL_WRITER)
    repo = os.path.dirname(os.path.abspath(__file__))
    procs, errs = {}, []
    try:
        for mode in "abc":
            os.makedirs(os.path.join(tmp, mode))
            errs.append(open(os.path.join(tmp, mode, "stderr"), "w"))
            procs[mode] = subprocess.Popen(
                [sys.executable, writer, repo, os.path.join(tmp, mode, "db.zebra"), rows_path,
                 mode, str(KILL_CALLS), str(KILL_REMOVE)],
                stdout=subprocess.PIPE, stderr=errs[-1], text=True)
        with ThreadPoolExecutor(3) as pool:
            evs = dict(zip("abc", pool.map(lambda m: drive_writer(procs[m], m), "abc")))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            p.stdout.close()
        for f in errs:
            f.close()
    writers_s = time.perf_counter() - t_phase
    span = None
    for mode, ev in evs.items():
        print(f"kill ({mode}): exit {ev['rc']}; " + "; ".join(ev["lines"][: ev["at"]])
              + " -> killed -> " + "; ".join(ev["lines"][ev["at"]:]))
        if ev["killed"] is None or ev["rc"] != -signal.SIGKILL:
            with open(os.path.join(tmp, mode, "stderr")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(ev["killed"] is not None and ev["rc"] == -signal.SIGKILL,
              f"writer ({mode}) ended other than by the parent's kill")
        span = int(ev["lines"][0].split()[2])
    print(f"kill (c): the log fold {'started' if evs['c']['fold'] else 'never started'} "
          f"within the calls")
    logs = {m: os.path.getsize(os.path.join(tmp, m, "db.zebra.d", "delta.log")) for m in "abc"}
    # reopen all three on the card (each replays its log; a retrain the
    # replay wants builds in the background meanwhile), then check each
    def reopen(mode):
        path = os.path.join(tmp, mode, "db.zebra")
        t0 = time.perf_counter()
        db = zt.Database.open(path, device="cuda")
        return db, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # the three replays side by side
        opened = dict(zip("abc", pool.map(reopen, "abc")))
    reopen_s = time.perf_counter() - t0
    dbs = {m: db for m, (db, _) in opened.items()}
    replay_s = {m: s for m, (_, s) in opened.items()}
    for mode in "abc":
        path = os.path.join(tmp, mode, "db.zebra")
        print(f"kill ({mode}): reopened in {replay_s[mode]:.2f} s (the three side by side in "
              f"{reopen_s:.2f} s), replaying {logs[mode]} log bytes; a fold's temporary "
              f"directory left: {os.path.isdir(f'{path}.d/index.fold')}; snapshot holds rows: "
              f"{read_meta(f'{path}.d/index')['has_state']}")
    recs, launches, qv = {}, 0, None
    for mode in "abc":
        recs[mode], n, qv = kill_check(torch, V, R, IC, dbs[mode], f"kill ({mode}) ", rows,
                                       evs[mode], os.path.join(tmp, mode), span)
        launches += n
    entry = kill_kernel_entry(torch, V, R, IC, dbs["c"], qv, launches)
    for db in dbs.values():
        db.wait_for_retrain()
        db.wait_for_fold()
    del dbs
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"kill: phase {phase_s:.1f} s (writers {writers_s:.1f} s, the reopens side by side "
          f"{reopen_s:.2f} s: " + ", ".join(f"({m}) {s:.2f} s" for m, s in replay_s.items())
          + f"); kernel 1 launched {launches} times by the reopened databases' queries")
    rec = {"phase_s": phase_s, "writers_s": writers_s, "reopen_s": reopen_s,
           "replay_s": replay_s,
           "fold_started": evs["c"]["fold"], "launches": launches, **recs}
    return rec, entry


def kernels_record(forms, path_forms, ivf_total, lsh_run, lsh_rec, wave_forms, path_recs,
                   wave_by_form, wave_launches, aug_launches, aug_by_form, aug_forms):
    """The kernels' JSON record: one entry per TPU kernel, each with its
    ``forms``. ``path_forms`` is the launch count by form of each path that
    runs kernel 1."""
    source = {"query": "zebra_tpu_torch/csrc/ivf_rerank.cu",
              "cluster": "zebra_tpu_torch/csrc/ivf_rerank_cluster.cu"}

    def entry(name, replaces, n, r, src=None):
        return {"name": name, "route": "cuda",
                "source": src or f"zebra_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": n, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                # no single PyTorch call gathers, scores and selects per query
                "library_ms": None}

    def form_records(recs, path_launches, query_src=source["query"]):
        """each "<slab>/<kernel>" form: its source, launches over the paths,
        time, plain version's time and bound (synthetic state, and on the
        path's own probes where a path runs the slab form)"""
        out = {}
        for key, r in recs.items():
            kind = key.split("/")[1]
            src = source["cluster"] if kind == "cluster" else query_src
            out[key] = {"source": src, "launches": path_launches.get(key, 0),
                        **r}
        return out

    # kernel 1: the entry's numbers are those of the form the defaults path
    # launched most, on the synthetic state at B=16384 (as in earlier runs);
    # every form's, on the synthetic state and on its path's probes, under "forms"
    ivf_launches = {}
    for by_form in path_forms:
        for key, n in by_form.items():
            ivf_launches[key] = ivf_launches.get(key, 0) + n
    main_form = max(path_forms[0], key=path_forms[0].get)
    ivf_rec = {**forms[main_form], "max_abs_err": max(
        max(f.get("max_abs_err", 0.0), f.get("path_max_abs_err", 0.0)) for f in forms.values())}
    # kernel 2: the refine path's probes at B=16384, the form it launched most
    wave_main = max(wave_by_form, key=wave_by_form.get)
    wave_rec = {**path_recs[wave_main], "max_abs_err": max(
        [r["max_abs_err"] for r in path_recs.values()]
        + [r["max_abs_err"] for r in wave_forms.values()])}
    for key, r in path_recs.items():
        wave_forms[key] = {**wave_forms.get(key, {}), **{f"path_{k}": v for k, v in r.items()}}
    return {"kernels": [
        {**entry("ivf_rerank", "zebra_tpu/ops/pallas_ivf.py:72", ivf_total,
                 ivf_rec, source[main_form.split("/")[1]]),
         "forms": form_records(forms, ivf_launches)},
        # one TPU kernel, two forms on the card: the entry's source and time
        # are those of the slab-major form, which the path launched
        {**entry("lsh_rerank_slab", "zebra_tpu/ops/pallas_rerank.py:48", lsh_run["launches"],
                 {**lsh_run, "max_abs_err": max(lsh_rec["max_abs_err"], lsh_run["max_abs_err"])}),
         "name": "lsh_rerank",
         "forms": {"slab": {"source": "zebra_tpu_torch/csrc/lsh_rerank_slab.cu",
                            "launches": lsh_run["launches_slab"], "ms": lsh_run["ms"]},
                   "gather": {"source": "zebra_tpu_torch/csrc/lsh_rerank.cu",
                              "launches": lsh_run["launches"] - lsh_run["launches_slab"],
                              "ms": lsh_run["gather_ms"]}}},
        {**entry("ivf_rerank_wave", "zebra_tpu/ops/experimental_ivf.py:34", wave_launches,
                 wave_rec, source["cluster"] if wave_main.endswith("cluster") else None),
         "forms": form_records(wave_forms, wave_by_form,
                               "zebra_tpu_torch/csrc/ivf_rerank_wave.cu")},
        # kernel 3: the entry's numbers are the redesigned form's, bf16 at
        # B=16384 (the driven run launched both forms equally often)
        {**entry("ivf_rerank_aug", "zebra_tpu/ops/experimental_ivf.py:178", aug_launches,
                 {**aug_forms["bf16/cluster"], "max_abs_err": max(
                     r["max_abs_err"] for r in aug_forms.values())}, source["cluster"]),
         "forms": form_records(aug_forms, aug_by_form, "zebra_tpu_torch/csrc/ivf_rerank_aug.cu")},
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import zebra_tpu_torch as zt
        from zebra_tpu_torch.index import buckets as TB
        from zebra_tpu_torch.index import ivf as V
        from zebra_tpu_torch.ops import _kernels
        from zebra_tpu_torch.ops import experimental_ivf as TX
        from zebra_tpu_torch.ops import ivf_cluster as IC
        from zebra_tpu_torch.ops import ivf_rerank as R
        from zebra_tpu_torch.ops import lsh_rerank as LR
        from zebra_tpu_torch.utils import make_data
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must stay off")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def lap(phase):
        print(f"phase {phase} starts {time.perf_counter() - t_start:.1f} s after the card check")

    # phase 2: build, one nvcc per kernel, all at once
    kernels = ("ivf_rerank", "lsh_rerank", "lsh_rerank_slab", "ivf_rerank_wave",
               "ivf_rerank_aug", "ivf_rerank_cluster")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        libs = dict(zip(kernels, pool.map(_kernels.load, kernels)))
    print(f"build: {', '.join(kernels)} in {time.perf_counter() - t0:.2f} s")
    for name in kernels:
        log = _kernels.BUILD_LOG.get(name, "")
        regs = [int(line.split("Used ")[1].split()[0]) for line in log.splitlines()
                if "Used " in line and "registers" in line]
        spills = sum("spill" in line and " 0 bytes spill stores" not in line
                     for line in log.splitlines())
        if regs:
            print(f"ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                  f"{spills} with spills")
    print_sass_counts(libs)

    lap(3)
    # phase 3: IVF kernel parity and timing, every slab form, both kernel forms
    forms = kernel_parity(torch, V, R, IC, device)

    t0 = time.perf_counter()
    data = make_data(N_ROWS + N_QUERIES, DIM, SEED)
    base, queries = data[:N_ROWS], data[N_ROWS:]
    print(f"data: {N_ROWS} + {N_QUERIES} x {DIM} (utils.make_data, seed {SEED}) in "
          f"{time.perf_counter() - t0:.2f} s")

    lap(4)
    # phase 4: the IVF path at the library defaults
    pipe_recs = {}
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_")
    try:
        launches, db, _, scan_rows, scan_forms, pipe_recs["defaults"] = main_path(
            torch, zt, V, tmp, base, queries, zt.DatabaseConfig(dim=DIM), "", (R, "LAUNCHES"))
        check({f.split("/")[0] for f in scan_forms} == {"int8+residual"},
              "the defaults must launch only the int8 + residual slab form")
        check(scan_forms.get("int8+residual/cluster", 0) > 0,
              "the defaults path must run the cluster-major form at batch 16384")
        check(db.index.options.rerank == "cuda" and db.index.options.refine == "scan",
              "the bare defaults must resolve to the probe kernel in scan mode")
        for key, rec in probe_path_stages(torch, V, R, IC, db, queries, True, "").items():
            forms[key] = {**forms.get(key, {}), **{f"path_{k}": v for k, v in rec.items()}}
        del db
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(5)
    # phase 5: LSH kernel parity and timing
    lsh_rec = lsh_kernel_parity(torch, LR, device)

    lap(6)
    # phase 6: the LSH path
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_lsh_")
    try:
        lsh_run = lsh_path(torch, zt, TB, LR, tmp, base, queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(7)
    # phase 7: wave kernel parity and timing, both kernel forms
    wave_forms = wave_kernel_parity(torch, V, TX, IC, device)

    lap(8)
    # phase 8: the gather-refine path through the wave kernel
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_refine_")
    try:
        cfg = zt.DatabaseConfig(dim=DIM, index=zt.IndexOptions(refine=4, rerank="pallas2"))
        R.LAUNCHES = 0
        wave_launches, db, ids, _, wave_by_form, pipe_recs["refine"] = main_path(
            torch, zt, V, tmp, base, queries, cfg, "refine ", (TX, "LAUNCHES_WAVE"))
        check(db.index.options.rerank == "cuda2" and R.LAUNCHES == 0,
              "refine=4 with rerank='pallas2' must run the wave kernel, never the probe kernel")
        check(wave_by_form.get("int8/cluster", 0) > 0,
              "the refine=4 path must run the cluster-major form at batch 16384")
        path_recs = refine_path_stages(torch, V, TX, IC, db, ids, queries, scan_rows)
        del db, ids
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(9)
    # phase 9: the augmented-slab surface, both kernel forms
    aug_launches, aug_by_form, aug_forms = aug_path(torch, V, TX, IC, device)

    lap(10)
    # phase 10: the bf16 "balanced" tier through kernel 1's bf16 forms
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_balanced_")
    try:
        cfg = zt.DatabaseConfig(dim=DIM, index=zt.IndexOptions.tier("balanced"))
        bal_launches, db, _, _, bal_forms, pipe_recs["balanced"] = main_path(
            torch, zt, V, tmp, base, queries, cfg, "balanced ", (R, "LAUNCHES"))
        check({f.split("/")[0] for f in bal_forms} == {"bf16"},
              "the balanced tier must launch only the bf16 slab form")
        check(bal_forms.get("bf16/cluster", 0) > 0,
              "the balanced path must run the cluster-major form at batch 16384")
        check(db.index.options.rerank == "cuda" and db.index.state.vectors.dtype == torch.bfloat16
              and db.index.state.scales is None,
              "the balanced tier must store a bf16 slab and run the probe kernel")
        for key, rec in probe_path_stages(torch, V, R, IC, db, queries, False,
                                          "balanced ").items():
            forms[key] = {**forms.get(key, {}), **{f"path_{k}": v for k, v in rec.items()}}
        del db
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(11)
    # phase 11: the f32 tier through kernel 1's f32 forms
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_f32_")
    try:
        cfg = zt.DatabaseConfig(dim=DIM, index=zt.IndexOptions(dtype="float32"))
        f32_launches, db, _, _, f32_forms, pipe_recs["f32"] = main_path(
            torch, zt, V, tmp, base, queries, cfg, "f32 ", (R, "LAUNCHES"))
        check({f.split("/")[0] for f in f32_forms} == {"f32"},
              "the f32 tier must launch only the f32 slab form")
        check(f32_forms.get("f32/cluster", 0) > 0,
              "the f32 path must run the cluster-major form at batch 16384")
        check(db.index.options.rerank == "cuda" and db.index.state.vectors.dtype == torch.float32
              and db.index.state.scales is None and db.index.options.resolved_probes() == 4
              and not db.index.options.query_wire_is_bf16(),
              "the f32 tier must store an f32 slab, probe 4 blocks and ship f32 queries")
        for key, rec in probe_path_stages(torch, V, R, IC, db, queries, False, "f32 ").items():
            forms[key] = {**forms.get(key, {}), **{f"path_{k}": v for k, v in rec.items()}}
        del db
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(13)
    # phase 13: the growing database at the library defaults
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_growth_")
    try:
        growth_forms, pipe_recs["growth"] = growth_path(torch, zt, V, R, IC, tmp, base,
                                                            queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(14)
    # phase 14: the exact tier and the elementwise metrics on the same rows
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_flat_")
    try:
        pipe_recs["flat"] = flat_path(torch, zt, V, TB, R, tmp, base, queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(16)
    # phase 16: the sharded database (4 shards on the card), the towers' mesh
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_sharded_")
    try:
        sharded_forms, sharded_lsh, pipe_recs["sharded"] = sharded_path(
            torch, zt, V, R, IC, LR, tmp, base, queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(17)
    # phase 17: writers killed on the card, their databases reopened here
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_kill_")
    try:
        pipe_recs["kill"], kill_entry = kill_path(torch, zt, V, R, IC, tmp, base)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del data, base, queries

    lap(12)
    # phase 12: the text document path (defaults.text_db, BGE-small on the card)
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_text_")
    try:
        text_entry, pipe_recs["text"] = text_path(torch, zt, V, R, IC, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap(15)
    # phase 15: the image and audio document paths (ViT on the card), the CLI
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_media_")
    try:
        media_entries, pipe_recs["media"] = media_path(torch, zt, V, R, IC, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    growth_launches = sum(growth_forms.values())
    sharded_launches = sum(sharded_forms.values())
    print(f"launches: ivf_rerank {launches} {scan_forms} (defaults), {bal_launches} "
          f"{bal_forms} (balanced), {f32_launches} {f32_forms} (f32), {growth_launches} "
          f"{growth_forms} (growing database) and {sharded_launches} {sharded_forms} "
          f"(4 shards), lsh_rerank "
          f"{lsh_run['launches']} (slab-major form {lsh_run['launches_slab']}) and "
          f"{sharded_lsh['launches']} ({sharded_lsh['launches_slab']}) (4 shards), "
          f"ivf_rerank_wave {wave_launches} {wave_by_form}, ivf_rerank_aug {aug_launches} "
          f"{aug_by_form}, ivf_rerank {text_entry['launches']} {pipe_recs['text']['launches']} "
          f"(text documents), {media_entries[0]['launches']} "
          f"{pipe_recs['media']['image']['launches']} (image documents), "
          f"{media_entries[1]['launches']} {pipe_recs['media']['audio']['launches']} (audio "
          f"documents, 2 s clips) and {media_entries[2]['launches']} "
          f"{pipe_recs['media']['audio_wide']['launches']} (audio documents, 30 s clips) and "
          f"{kill_entry['launches']} (the databases reopened after the kills) over "
          f"their paths; the whole run took "
          f"{time.perf_counter() - t_start:.0f} s after the card check")

    print("pipeline: " + json.dumps(pipe_recs | {"lsh": lsh_run["pipeline"]}))
    lsh_all = {**lsh_run, "launches": lsh_run["launches"] + sharded_lsh["launches"],
               "launches_slab": lsh_run["launches_slab"] + sharded_lsh["launches_slab"]}
    record = kernels_record(
        forms, (scan_forms, bal_forms, f32_forms, growth_forms, sharded_forms),
        launches + bal_launches + f32_launches + growth_launches + sharded_launches,
        lsh_all, lsh_rec, wave_forms, path_recs, wave_by_form, wave_launches, aug_launches,
        aug_by_form, aug_forms)
    record["kernels"].append(text_entry)
    record["kernels"].extend(media_entries)
    record["kernels"].append(kill_entry)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
