"""The port's CLI (``python -m zebra_tpu_torch.cli``) through the text cases of
the JAX package's ``tests/test_cli.py``, on the CPU (``--device cpu``) with
the default text database (BGE-small at full width, offline: the hashing
tokenizer and random-init weights); the image and audio verbs fail naming
the towers' ROADMAP entry."""

import json
import os
import subprocess
import sys

import pytest

from zebra_tpu_torch.cli import build_parser, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ZEBRA_TPU_WEIGHTS_CACHE", str(tmp_path / "weights"))
    yield tmp_path


def test_text_insert_query_clear(capsys):
    db = "t.zebra"
    assert main(["--database-path", db, *CPU, "text", "insert", "apple pie recipe",
                 "rocket science"]) == 0
    captured = capsys.readouterr()
    assert "Inserted 2" in captured.out and "384-dimensional" in captured.out
    assert "random-init BGE weights" in captured.err and "NOT be semantic" in captured.err
    assert main(["--database-path", db, *CPU, "text", "query", "apple pie recipe", "-n", "1"]) == 0
    out = capsys.readouterr().out
    assert "apple pie recipe" in out and "rocket science" not in out
    assert main(["--database-path", db, *CPU, "text", "clear"]) == 0
    assert not os.path.exists(db) and not os.path.exists(db + ".d")


def test_text_insert_from_files(tmp_path, capsys):
    files = []
    for i in range(7):
        p = tmp_path / f"f{i}.txt"
        p.write_text(f"file content number {i}")
        files.append(str(p))
    assert main(["--database-path", "f.zebra", *CPU, "text", "insert-from-files", *files,
                 "--batch-size", "3"]) == 0
    assert "Inserted 7" in capsys.readouterr().out
    assert main(["--database-path", "f.zebra", *CPU, "text", "query",
                 "file content number 3"]) == 0
    assert "file content number 3" in capsys.readouterr().out


def test_stats_verb(capsys):
    db = "st.zebra"
    main(["--database-path", db, *CPU, "text", "insert", "alpha", "beta"])
    capsys.readouterr()
    assert main(["--database-path", db, *CPU, "text", "stats"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["records"] == 2
    assert info["config"]["dim"] == 384 and info["config"]["metric"] == "sql2"
    assert info["index"]["built"] is True
    assert info["model"]["model"] == "bge-small-en-v1.5" and not info["model"]["semantic"]


def test_query_empty_database(capsys):
    assert main(["--database-path", "e.zebra", *CPU, "text", "query", "nothing"]) == 0
    assert "empty" in capsys.readouterr().out.lower()


@pytest.mark.parametrize("argv", [["image", "insert", "x.png"], ["audio", "insert", "x.wav"],
                                  ["image", "insert-from-files", "x.png"],
                                  ["image", "stats"], ["audio", "stats"]])
def test_image_and_audio_verbs_name_the_towers_item(argv, tmp_path, capsys):
    """The towers are ported (``tests/test_torch_media.py`` drives their
    verbs): a file that is not an image or a clip is refused with one error
    line, and ``stats`` answers with the tower's status."""
    (tmp_path / argv[-1]).write_bytes(b"not a real file")
    rc = main(["--database-path", f"{argv[0]}.zebra", *CPU, *argv])
    out = capsys.readouterr()
    assert "Traceback" not in out.err
    if argv[1] == "stats":
        assert rc == 0
        info = json.loads(out.out)
        assert info["records"] == 0 and info["config"]["dim"] == 768
        assert info["model"]["model"] == ("vit-audio" if argv[0] == "audio"
                                          else "vit-base-patch16-224")
    else:
        assert rc == 1 and "error:" in out.err


@pytest.mark.parametrize("argv", [["image", "query", "x.png", "--preview"],
                                  ["audio", "query", "x.wav", "--play"]])
def test_media_query_flags_parse_and_an_empty_database_answers(argv, tmp_path, capsys):
    """``--preview`` and ``--play`` are registered; an empty database answers
    before any model is asked, as in the JAX package."""
    (tmp_path / argv[2]).write_bytes(b"not a real file")
    assert main(["--database-path", f"{argv[0]}.zebra", *CPU, *argv]) == 0
    assert "empty" in capsys.readouterr().out.lower()


def test_missing_file_and_offline_fetch(monkeypatch, capsys):
    assert main(["--database-path", "m.zebra", *CPU, "text", "insert-from-files",
                 "nope.txt"]) == 1
    assert "nope.txt: no such file" in capsys.readouterr().err
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # as on a box without it
    assert main(["fetch-weights", "bge-small"]) == 1
    assert "huggingface_hub" in capsys.readouterr().err


def test_parser_is_the_jax_packages():
    """The same verbs and options as ``zebra_tpu/cli.py``, plus ``--device``."""
    from zebra_tpu.cli import build_parser as jax_parser

    def shape(parser):
        out = {}
        for action in parser._actions:
            if action.option_strings:
                out[tuple(action.option_strings)] = action.default
            elif hasattr(action, "choices") and isinstance(action.choices, dict):
                out[action.dest] = {k: shape(v) for k, v in action.choices.items()}
        return out

    mine, theirs = shape(build_parser()), shape(jax_parser())
    assert mine.pop(("--device",)) is None
    assert mine == theirs


def test_module_entry_point(tmp_path):
    """``python -m zebra_tpu_torch.cli`` in a fresh process: an image insert
    fails with one error line and no traceback."""
    (tmp_path / "x.png").write_bytes(b"not a real file")
    env = {**os.environ, "PYTHONPATH": REPO, "ZEBRA_TPU_WEIGHTS_CACHE": str(tmp_path / "w")}
    proc = subprocess.run([sys.executable, "-m", "zebra_tpu_torch.cli", "--database-path",
                           "p.zebra", *CPU, "image", "insert", "x.png"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ""
    lines = proc.stderr.splitlines()
    assert lines[-1].startswith("error: cannot identify image file")
    assert all(line.startswith("WARNING: ") for line in lines[:-1])  # the random-init tower
    assert "Traceback" not in proc.stderr
