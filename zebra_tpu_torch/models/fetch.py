"""Optional weight acquisition (the port of ``zebra_tpu/models/fetch.py``).

Model loading stays explicit (a database open never touches the network):
``python -m zebra_tpu_torch.cli fetch-weights bge-small`` (or ``vit`` /
``all``) downloads the safetensors and the tokenizer vocabulary into a local
cache, and the text tower resolves that cache when ``ZEBRA_TPU_BGE_WEIGHTS``
is unset. The cache root is the JAX package's (``ZEBRA_TPU_WEIGHTS_CACHE``,
default ``~/.cache/zebra_tpu/weights``), so weights fetched for one package
serve both. Without ``huggingface_hub`` or a network the fetch fails with an
error that names what was unreachable and the environment variable to set.
"""

from __future__ import annotations

import os

from zebra_tpu_torch.profiling import logger

#: hf-hub repositories of the supported models
SPECS = {
    "bge-small": {
        "repo": "BAAI/bge-small-en-v1.5",
        "files": ["model.safetensors", "vocab.txt"],
        "env": "ZEBRA_TPU_BGE_WEIGHTS",
    },
    "vit": {
        "repo": "google/vit-base-patch16-224",
        "files": ["model.safetensors"],
        "env": "ZEBRA_TPU_VIT_WEIGHTS",
    },
}


def cache_dir(model: str) -> str:
    """Local weight cache for one model (override root with
    ``ZEBRA_TPU_WEIGHTS_CACHE``)."""
    root = os.environ.get("ZEBRA_TPU_WEIGHTS_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "zebra_tpu", "weights"
    )
    return os.path.join(root, model)


def cached_weights(model: str) -> str | None:
    """Path of a previously fetched ``model.safetensors`` (None if absent).

    This is the implicit fallback the model loaders consult when their
    ``ZEBRA_TPU_*_WEIGHTS`` env var is unset — a successful
    ``fetch-weights`` run makes text/image search semantic with zero
    configuration, matching the reference's out-of-the-box behaviour.
    """
    p = os.path.join(cache_dir(model), "model.safetensors")
    return p if os.path.exists(p) else None


def fetch(model: str, revision: str | None = None) -> str:
    """Download one model's weights into the cache; returns the directory.

    Raises ``RuntimeError`` with an honest, actionable message when the
    machine has no way to fetch (no ``huggingface_hub``, or no network).
    Already-cached files are kept (hf_hub verifies by etag when online).
    """
    if model not in SPECS:
        raise ValueError(f"unknown model {model!r}: pick from {sorted(SPECS)}")
    spec = SPECS[model]
    dest = cache_dir(model)
    os.makedirs(dest, exist_ok=True)
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            "weight fetch needs the `huggingface_hub` package "
            "(`pip install huggingface_hub`); alternatively download "
            f"{spec['files']} from https://huggingface.co/{spec['repo']} "
            f"yourself and set {spec['env']}"
        ) from e
    for fname in spec["files"]:
        target = os.path.join(dest, fname)
        if os.path.exists(target):
            logger.info("fetch-weights: %s already cached at %s", fname, target)
            continue
        try:
            got = hf_hub_download(
                repo_id=spec["repo"], filename=fname, revision=revision
            )
        except Exception as e:  # no network / auth / 404 — be honest
            raise RuntimeError(
                f"could not fetch {spec['repo']}/{fname}: {e}. "
                "If this machine has no network access, download the file "
                f"elsewhere and set {spec['env']} to its path."
            ) from e
        # hard-link into our stable cache layout (copy across filesystems)
        try:
            os.link(got, target)
        except OSError:
            import shutil

            shutil.copyfile(got, target)
        logger.info("fetch-weights: %s -> %s", fname, target)
    return dest
