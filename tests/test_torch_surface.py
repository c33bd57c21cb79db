"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported here).

Every public module-level function and class, every public method of a
public class and every ``__all__`` name of ``zebra_tpu`` must have a twin of
the same name at the same path of ``zebra_tpu_torch`` (a method may come
from a base class of the port), unless :data:`NOT_PORTED` names it with its
reason. An entry of that list that no longer names something of the JAX
package the port lacks fails, so the list cannot go stale.
"""

from __future__ import annotations

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ORBAX = ("a JAX-library, multi-host checkpoint format: it needs orbax (which imports JAX), "
          "tensorstore and zstd (OCDBT + zarr), none of which the port depends on; the port "
          "raises at save (index/base.ORBAX_UNAVAILABLE) and at load (storage/snapshots.py)")
_AOT = ("the AOT warm surface: XLA compiles ahead of serving, with no torch counterpart "
        "(the port's warm_serving_shapes returns 0 and Database.wait_for_warm returns at once)")

#: what the port does not carry: "<module>" (the whole module) or
#: "<module>::<name>" -> (reason, the port files that take its place)
NOT_PORTED = {
    "storage/orbax_snap.py": (_ORBAX, ()),
    "index/base.py::BaseVectorIndex.warm_shapes": (_AOT, ()),
    "index/base.py::BaseVectorIndex.warm_query_aot": (_AOT, ()),
    "index/ivf_host.py::IVFIndex.warm_shapes": (_AOT, ()),
    "index/ivf_host.py::IVFIndex.warm_query_aot": (_AOT, ()),
    "db.py::Database._maybe_warm_shapes": (_AOT, ()),
    "ops/kmeans.py::warm_compile": (_AOT, ()),
    "utils.py::enable_compile_cache": ("points XLA's persistent compilation cache at a "
                                       "directory: torch compiles no query program", ()),
    "utils.py::measure_tunnel": ("times the JAX runtime's host <-> device transfers", (
        "utils.py",)),  # device_readback_mbs takes its place
    "ops/pallas_ivf.py": ("Pallas kernel 1 (_kernel_factory, pallas_call at :587) and its "
                          "adapter", ("csrc/ivf_rerank.cu", "csrc/ivf_rerank_cluster.cu",
                                      "ops/ivf_rerank.py", "ops/ivf_cluster.py")),
    "ops/pallas_rerank.py": ("Pallas kernel 4 (_kernel_factory, pallas_call at :196)", (
        "csrc/lsh_rerank.cu", "csrc/lsh_rerank_slab.cu", "ops/lsh_rerank.py")),
    "ops/experimental_ivf.py::_kernel_factory_v2": ("Pallas kernel 2, the wave re-rank", (
        "csrc/ivf_rerank_wave.cu", "csrc/ivf_rerank_cluster.cu")),
    "ops/experimental_ivf.py::_kernel_factory_v3": ("Pallas kernel 3, the aug-slab re-rank", (
        "csrc/ivf_rerank_aug.cu", "csrc/ivf_rerank_cluster.cu")),
    "ops/experimental_ivf.py::pallas_ivf_rerank_aug": ("kernel 3's Pallas call (:332)", (
        "csrc/ivf_rerank_aug.cu", "ops/experimental_ivf.py")),
}


def _modules(pkg: str) -> dict[str, ast.Module]:
    root = os.path.join(REPO, pkg)
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    out[os.path.relpath(path, root)] = ast.parse(fh.read(), path)
    return out


JAX = _modules("zebra_tpu")
PORT = _modules("zebra_tpu_torch")


def _all_names(tree: ast.Module) -> list[str]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [e.value for e in node.value.elts]
    return []


def _methods(cls: ast.ClassDef) -> set[str]:
    out = set()
    for m in cls.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(m.name)
        elif isinstance(m, (ast.Assign, ast.AnnAssign)):
            for t in (m.targets if isinstance(m, ast.Assign) else [m.target]):
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def public_names(tree: ast.Module) -> set[str]:
    """The JAX side: public functions and classes, ``Class.method`` (methods
    and properties; not dataclass fields), and ``__all__:name``."""
    out = {f"__all__:{n}" for n in _all_names(tree)}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def all_defined(tree: ast.Module) -> set[str]:
    """Every name a JAX module defines, private ones too (for the list's
    staleness check)."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m}" for m in _methods(node)}
    return out


class Port:
    """Names bound in the port's modules, methods resolved through base
    classes of the port (``from zebra_tpu_torch... import`` or the same
    module) and module-level aliases (``IndexState = LSHState``)."""

    def __init__(self, modules: dict[str, ast.Module]):
        self.modules = modules

    @staticmethod
    def _rel(dotted: str) -> list[str]:
        parts = dotted.split(".")[1:]
        return ["/".join(parts) + ".py", "/".join(parts + ["__init__.py"])]

    def _lookup(self, rel: str, name: str, depth: int = 0):
        """The ``ClassDef`` that ``name`` is in module ``rel``, or None."""
        tree = self.modules.get(rel)
        if tree is None or depth > 8:
            return None
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == name:
                return rel, node
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets):
                return self._lookup(rel, node.value.id, depth + 1)
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                    "zebra_tpu_torch"):
                for a in node.names:
                    if (a.asname or a.name) == name:
                        for cand in self._rel(node.module):
                            hit = self._lookup(cand, a.name, depth + 1)
                            if hit:
                                return hit
        return None

    def class_members(self, rel: str, name: str) -> set[str]:
        hit = self._lookup(rel, name)
        if hit is None:
            return set()
        mod, cls = hit
        out = _methods(cls)
        for b in cls.bases:
            if isinstance(b, ast.Name):
                out |= self.class_members(mod, b.id)
        return out

    def bound(self, rel: str) -> set[str]:
        tree = self.modules[rel]
        out = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                out.add(node.target.id)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        # names a module-level __getattr__ serves lazily
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
                out |= {c.value for c in ast.walk(node)
                        if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        return out

    def has(self, rel: str, name: str) -> bool:
        if rel not in self.modules:
            return False
        if name.startswith("__all__:"):
            want = name.split(":", 1)[1]
            return want in _all_names(self.modules[rel]) and want in self.bound(rel)
        if "." in name:
            cls, member = name.split(".", 1)
            return member in self.class_members(rel, cls)
        return name in self.bound(rel)


PORTED = Port(PORT)


def _excused(rel: str, name: str) -> bool:
    return rel in NOT_PORTED or f"{rel}::{name}" in NOT_PORTED


def test_every_public_name_has_a_twin():
    missing = [f"{rel}::{name}" for rel, tree in sorted(JAX.items())
               for name in sorted(public_names(tree))
               if not _excused(rel, name) and not PORTED.has(rel, name)]
    assert not missing, f"public names of zebra_tpu without a twin in the port: {missing}"


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_not_ported_entries_are_live(entry):
    """Each entry names a module or name of the JAX package that the port
    lacks, gives a reason, and every port file it names exists."""
    reason, files = NOT_PORTED[entry]
    assert len(reason) > 20
    for f in files:
        assert os.path.exists(os.path.join(REPO, "zebra_tpu_torch", f)), (entry, f)
    rel, _, name = entry.partition("::")
    assert rel in JAX, f"{entry}: no such module in zebra_tpu"
    if not name:
        assert rel not in PORT, f"{entry}: the port now has this module"
        return
    assert name in all_defined(JAX[rel]), f"{entry}: zebra_tpu no longer defines it"
    assert rel not in PORT or not PORTED.has(rel, name), f"{entry}: the port now has it"


def test_no_port_file_imports_jax():
    """No file of the port (its tool scripts too) imports ``jax``, ``flax``
    or the JAX package."""
    bad = []
    for rel, tree in PORT.items():
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(rel, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "zebra_tpu", "orbax")]
    assert not bad, bad


def test_the_all_lists_match():
    """Each ``__all__`` of the JAX package has the same names in the port
    (in the same order where the port adds none)."""
    for rel, tree in JAX.items():
        want = _all_names(tree)
        if not want or rel in NOT_PORTED:
            continue
        got = _all_names(PORT[rel])
        assert set(want) <= set(got), (rel, sorted(set(want) - set(got)))
    assert _all_names(PORT["__init__.py"]) == _all_names(JAX["__init__.py"])
