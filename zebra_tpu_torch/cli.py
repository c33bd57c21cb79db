"""Command-line interface of the torch port (the parser of ``zebra_tpu/cli.py``).

    python -m zebra_tpu_torch.cli [--database-path P] [--device D] MODALITY VERB ...

  text  {insert, insert-from-files, query, clear, stats}
  image {insert, insert-from-files, query, clear, stats}
  audio {insert, insert-from-files, query, clear, stats}
  fetch-weights {bge-small, vit, all}

``--database-path`` (default ``zebra.db``) and ``--device`` are global flags
and come before the modality. The port runs on the card unless
``--device cpu`` asks for the CPU. Batch ingest takes ``--batch-size``
(default 100), queries ``--number-of-results`` / ``-n`` (default 1) and
``--output-dir`` (retrieved image / audio blobs are written there).
``image query --preview`` writes each hit as sixel graphics to standard
output (the reference draws hits with viuer); ``audio query --play`` decodes
each hit through the audio model's chain and plays it as PCM WAV through the
first system player found (aplay, paplay, afplay; the reference plays with
rodio).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys

from zebra_tpu_torch.utils import Stopwatch


def _progress(i: int, total: int) -> None:
    width = 30
    done = int(width * i / max(total, 1))
    sys.stderr.write(f"\r[{'#' * done}{'.' * (width - done)}] {i}/{total}")
    if i == total:
        sys.stderr.write("\n")
    sys.stderr.flush()


def _open_db(args):
    from zebra_tpu_torch import defaults

    factory = {"text": defaults.text_db, "image": defaults.image_db,
               "audio": defaults.audio_db}[args.modality]
    db = factory(args.database_path, device=args.device)
    _warn_degraded(db)
    return db


def _warn_degraded(db) -> None:
    """Print the embedding path's degradations on stderr: a user must not
    mistake hash-tokenizer or random-init results for semantic search."""
    try:
        status = db.model_status()
    except Exception:
        return
    for d in status.get("degradations", []):
        sys.stderr.write(f"WARNING: {status.get('model')}: {d}\n")
    if status.get("degradations"):
        sys.stderr.write("WARNING: results will NOT be semantic until the above is fixed.\n")
        sys.stderr.flush()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _cmd_insert(args) -> int:
    db = _open_db(args)
    if args.modality == "text":
        docs = [t.encode() for t in args.items]
    else:
        docs = [_read(p) for p in args.items]
    sw = Stopwatch()
    ids = db.insert_documents(docs)
    print(f"Inserted {len(ids)} {args.modality} document(s) "
          f"({db.config.dim}-dimensional embeddings) in {sw.pretty()}.")
    return 0


def _read_files_parallel(paths: list[str]) -> list[bytes]:
    """Read ingest files on an I/O thread pool (file reads release the GIL)."""
    if len(paths) < 4:
        return [_read(p) for p in paths]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(16, len(paths))) as pool:
        return list(pool.map(_read, paths))


def _cmd_insert_from_files(args) -> int:
    db = _open_db(args)
    sw = Stopwatch()
    docs = _read_files_parallel(list(args.items))
    total = 0
    for start in range(0, len(docs), args.batch_size):
        batch = docs[start : start + args.batch_size]
        batch_sw = Stopwatch()
        db.insert_documents(batch)
        total += len(batch)
        _progress(total, len(docs))
        print(f"  batch of {len(batch)} in {batch_sw.pretty()}", file=sys.stderr)
    print(f"Inserted {total} document(s) from files in {sw.pretty()}.")
    return 0


def _cmd_query(args) -> int:
    db = _open_db(args)
    if args.modality == "text":
        queries = [t.encode() for t in args.items]
    else:
        queries = [_read(p) for p in args.items]
    sw = Stopwatch()
    results = db.query_documents(queries, number_of_results=args.number_of_results)
    elapsed = sw.pretty()
    if not results:
        print("Database is empty; no results.")
        return 0
    for qi in sorted(results):
        print(f"Query {qi}:")
        for doc_id, doc in results[qi].items():
            if args.modality == "text":
                print(f"  [{doc_id.hex()[:12]}] {doc.decode('utf-8', errors='replace')}")
                continue
            print(f"  [{doc_id.hex()[:12]}] {len(doc)} bytes")
            if args.modality == "image" and getattr(args, "preview", False):
                try:
                    from zebra_tpu_torch.sixel import sixel_encode

                    sys.stdout.write(sixel_encode(doc) + "\n")
                except Exception as e:  # a corrupt blob, or no Pillow to decode it
                    print(f"    (preview failed: {e})")
            if args.modality == "audio" and getattr(args, "play", False):
                err = _play_audio(doc)
                if err:
                    print(f"    (playback unavailable: {err}; use --output-dir to extract)")
            if args.output_dir:
                os.makedirs(args.output_dir, exist_ok=True)
                out = os.path.join(args.output_dir, f"{doc_id.hex()}.bin")
                with open(out, "wb") as f:
                    f.write(doc)
                print(f"    -> {out}")
    print(f"Queried {len(queries)} {args.modality} document(s) in {elapsed}.")
    return 0


def _play_audio(doc: bytes) -> str | None:
    """Play one retrieved audio blob through the first system player on the
    PATH, after decoding it through the audio model's chain and writing it as
    16-bit PCM WAV (so stored mp3 / FLAC / ... play as WAV-only players take
    them). Returns what went wrong, or None when it played."""
    import shutil
    import tempfile
    import wave

    import numpy as np

    try:
        from zebra_tpu_torch.models.audio import audio_to_data

        samples, rate = audio_to_data(doc)
        pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm)
    except Exception as e:
        return f"decode: {e}"
    for player in ("aplay", "paplay", "afplay"):
        path = shutil.which(player)
        if not path:
            continue
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(buf.getvalue())
            f.flush()
            try:
                subprocess.run([path, f.name], check=True, timeout=300, capture_output=True)
                return None
            except (OSError, subprocess.SubprocessError) as e:
                return f"{player}: {e}"
    return "no system audio player (aplay/paplay/afplay) on PATH"


def _cmd_clear(args) -> int:
    db = _open_db(args)
    db.clear_database()
    print(f"Cleared {args.modality} database at {args.database_path}.")
    return 0


def _cmd_stats(args) -> int:
    db = _open_db(args)
    info = {
        "records": len(db),
        "config": db.config.to_json(),
        "index": db.index.stats(),
        "model": db.model_status(),
    }
    print(json.dumps(info, indent=2))
    return 0


def _cmd_fetch_weights(args) -> int:
    """Explicit weight acquisition: a database open never touches the network."""
    from zebra_tpu_torch.models import fetch

    for m in (["bge-small", "vit"] if args.model == "all" else [args.model]):
        try:
            dest = fetch.fetch(m)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"Fetched {m} weights into {dest}.")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="zebra-tpu-torch",
        description="Embedded vector database on PyTorch + CUDA (text / image / audio).",
    )
    ap.add_argument("--database-path", default="zebra.db",
                    help="path to the database manifest file (default: zebra.db)")
    ap.add_argument("--device", default=None,
                    help="where the index and the model run (default: the CUDA card; "
                         "'cpu' for a CPU run)")
    sub = ap.add_subparsers(dest="modality", required=True)
    for modality in ("text", "image", "audio"):
        m = sub.add_parser(modality)
        verbs = m.add_subparsers(dest="verb", required=True)

        ins = verbs.add_parser("insert", help="insert documents")
        ins.add_argument("items", nargs="+", help="texts (text) or file paths (image/audio)")
        ins.set_defaults(fn=_cmd_insert)

        iff = verbs.add_parser("insert-from-files", help="batch ingest files")
        iff.add_argument("items", nargs="+", help="file paths")
        iff.add_argument("--batch-size", type=int, default=100)
        iff.set_defaults(fn=_cmd_insert_from_files)

        q = verbs.add_parser("query", help="query nearest documents")
        q.add_argument("items", nargs="+",
                       help="query texts (text) or file paths (image/audio)")
        q.add_argument("--number-of-results", "-n", type=int, default=1)
        q.add_argument("--output-dir", default="",
                       help="write retrieved image/audio blobs here")
        if modality == "image":
            q.add_argument("--preview", action="store_true",
                           help="render hits inline (sixel terminals)")
        if modality == "audio":
            q.add_argument("--play", action="store_true",
                           help="play hits through the system audio player")
        q.set_defaults(fn=_cmd_query)

        c = verbs.add_parser("clear", help="delete the database")
        c.set_defaults(fn=_cmd_clear)

        st = verbs.add_parser("stats", help="print database/index statistics")
        st.set_defaults(fn=_cmd_stats)

    fw = sub.add_parser(
        "fetch-weights",
        help="download model weights into the local cache (hf-hub); "
        "afterwards text/image search is semantic with zero env vars",
    )
    fw.add_argument("model", choices=["bge-small", "vit", "all"])
    fw.set_defaults(fn=_cmd_fetch_weights, verb="fetch-weights")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e.filename or e}: no such file", file=sys.stderr)
        return 1
    except (ValueError, NotImplementedError, RuntimeError, OSError) as e:
        # OSError: a file Pillow cannot identify as an image
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
