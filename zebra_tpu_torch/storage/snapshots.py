"""Streaming, np.load-compatible snapshot writer and memmap reader.

Port of ``zebra_tpu/storage/snapshots.py``: the same ``.npz`` container (a
ZIP_STORED archive of ``.npy`` members, readable by plain ``np.load``) written
in bounded chunks, so both packages read each other's snapshots. Torch tensors
(CPU or CUDA) are fetched chunk by chunk, so the slab never materialises
host-side whole (a :class:`StackedSource` member, a sharded index's per-shard
tensors, shard after shard); bfloat16 tensors are stored as raw uint16 bit
patterns (the JAX package's slab contract). A :class:`ChunkedSource` member is
produced chunk by chunk by a callback (the background log fold's fuzzy
capture, ``Database._fold_chunked_capture``), in the same bytes on disk.
"""

from __future__ import annotations

import contextlib
import os
import zipfile

import numpy as np
import torch

#: per-chunk byte budget for streamed members (device fetch + zip write)
CHUNK_BYTES = 64 << 20


class CaptureAborted(RuntimeError):
    """Raised by a :class:`ChunkedSource` fetch when the capture's premise
    broke mid-stream (a rebuild or retrain swap, an explicit save, a slab
    reallocation): the writer unwinds and the caller discards the file."""


class ChunkedSource:
    """Snapshot member whose rows come chunk by chunk from a callback:
    ``fetch(s, e) -> np.ndarray`` gives rows ``[s:e)`` in the encoded dtype
    (``dtype``; a bf16 slab's chunks as uint16 bits) and may raise
    :class:`CaptureAborted`."""

    def __init__(self, shape: tuple, dtype, fetch):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.fetch = fetch


class StackedSource:
    """Snapshot member ``[S, ...]`` made of S same-shaped tensors (a sharded
    index's per-shard states, each on its own device), written part by part
    without stacking them on a device. ``m[s:e]`` stacks parts ``s .. e-1``
    on the first part's device (a copy)."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.shape = (len(self.parts), *self.parts[0].shape)

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parts)

    def dim(self) -> int:
        return len(self.shape)

    def clone(self) -> "StackedSource":
        return StackedSource([p.clone() for p in self.parts])

    def __getitem__(self, sl: slice) -> torch.Tensor:
        dev = self.parts[0].device
        return torch.stack([p.to(dev) for p in self.parts[sl]])


#: members of a capture that live on a device (copied by a cloned capture)
DEVICE_MEMBERS = (torch.Tensor, StackedSource)


def member_nbytes(m) -> int:
    """Device bytes of a tensor or :class:`StackedSource` member."""
    return m.nbytes if isinstance(m, StackedSource) else m.numel() * m.element_size()


def _to_np(t) -> np.ndarray:
    """Host encoding of one member or chunk: bf16 -> uint16 bit patterns."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    arr = np.asarray(t)
    if arr.dtype.kind == "V" or arr.dtype.names:
        raise ValueError("structured arrays are not snapshot members")
    return arr


def slab_from_np(arr, device="cpu", dtype=None) -> torch.Tensor:
    """A slab tensor on ``device`` from its host form: uint16 bit patterns
    (the snapshot encoding of bf16) or an ``ml_dtypes`` bf16 array (a JAX
    state's leaf) become bf16, any other array keeps its type; ``dtype``,
    when given, casts the result."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).to(device).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def _member_meta(arr):
    """(shape, np dtype of the ENCODED stream) for any input array."""
    if isinstance(arr, ChunkedSource):
        return arr.shape, arr.dtype
    if isinstance(arr, StackedSource):
        return arr.shape, _member_meta(arr.parts[0])[1]
    if isinstance(arr, torch.Tensor):
        return tuple(arr.shape), _to_np(arr.reshape(-1)[:0]).dtype
    a = _to_np(arr)
    return tuple(a.shape), a.dtype


def _iter_source_chunks(src: ChunkedSource):
    """Yield the chunks of a :class:`ChunkedSource` in C order, each <=
    CHUNK_BYTES (a 0-d member in one fetch)."""
    shape, dtype = src.shape, src.dtype
    if len(shape) == 0:
        yield _to_np(src.fetch(0, 1)).reshape(())
        return
    row_bytes = dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
    rows = max(1, CHUNK_BYTES // max(row_bytes, 1))
    for s in range(0, shape[0], rows):
        yield np.ascontiguousarray(_to_np(src.fetch(s, min(shape[0], s + rows))))


def _iter_chunks(arr, shape, dtype):
    """Yield C-contiguous np chunks of ``arr`` along axis 0 (whole array for
    0-d), each <= CHUNK_BYTES; tensors fetch per chunk."""
    if isinstance(arr, ChunkedSource):
        yield from _iter_source_chunks(arr)
        return
    if isinstance(arr, StackedSource):
        for part in arr.parts:
            yield from _iter_chunks(part, shape[1:], dtype)
        return
    if len(shape) == 0:
        yield _to_np(arr).reshape(())
        return
    n = shape[0]
    row_bytes = dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
    rows = max(1, CHUNK_BYTES // max(row_bytes, 1))
    for s in range(0, n, rows):
        yield np.ascontiguousarray(_to_np(arr[s : s + rows]))


def _member_data_offset(f, header_offset: int) -> int:
    """File offset of a zip member's raw data (30 fixed header bytes + name
    + extra)."""
    f.seek(header_offset)
    hdr = f.read(30)
    if hdr[:4] != b"PK\x03\x04":
        raise ValueError("corrupt zip local header")
    name_len = int.from_bytes(hdr[26:28], "little")
    extra_len = int.from_bytes(hdr[28:30], "little")
    return header_offset + 30 + name_len + extra_len


_HEADER_READERS = {
    (1, 0): np.lib.format.read_array_header_1_0,
    (2, 0): np.lib.format.read_array_header_2_0,
}


def npz_member_memmap(path: str, name: str) -> np.ndarray:
    """Read-only ``np.memmap`` of one member of an uncompressed ``.npz``.
    Raises ``ValueError`` for compressed, Fortran-ordered or 0-d members."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(f"{name}.npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"member {name} is compressed; cannot memmap")
        header_offset = info.header_offset
    with open(path, "rb") as f:
        data_off = _member_data_offset(f, header_offset)
        f.seek(data_off)
        version = np.lib.format.read_magic(f)
        read_header = _HEADER_READERS.get(version)
        if read_header is None:
            raise ValueError(f"member {name} has .npy format {version}")
        shape, fortran, dtype = read_header(f)
        if fortran:
            raise ValueError(f"member {name} is Fortran-ordered")
        array_off = f.tell()
    if len(shape) == 0:
        raise ValueError(f"member {name} is 0-d")
    return np.memmap(path, dtype=dtype, mode="r", offset=array_off,
                     shape=shape, order="C")


class SnapshotReader:
    """Mapping view over a snapshot's arrays: read-only memmaps where
    possible, the eager ``NpzFile`` decode otherwise (0-d members)."""

    def __init__(self, path: str, npz):
        self._path = path
        self._npz = npz

    @property
    def files(self):
        return self._npz.files

    def __contains__(self, name: str) -> bool:
        return name in self._npz

    def __getitem__(self, name: str):
        try:
            return npz_member_memmap(self._path, name)
        except ValueError:
            return self._npz[name]


@contextlib.contextmanager
def open_snapshot_arrays(directory: str, meta: dict):
    """Yield the snapshot's array mapping (npz only: orbax snapshots are a
    JAX-library format the port does not read)."""
    if meta.get("snapshot_format", "npz") != "npz":
        raise NotImplementedError(
            f"{meta.get('snapshot_format')!r} snapshots are not readable by the "
            "torch port; re-save the index with snapshot_format='npz'"
        )
    path = os.path.join(directory, "arrays.npz")
    with np.load(path) as z:
        yield SnapshotReader(path, z)


def write_npz_streamed(path: str, arrays: dict, fsync: bool = True) -> None:
    """Write ``arrays`` (np arrays, scalars, torch tensors or
    :class:`ChunkedSource` members) as an uncompressed ``.npz`` with bounded
    memory; atomic (tmp file, fsync, rename, directory fsync). A fetch that
    raises leaves no file behind."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        _write_members(tmp, arrays, fsync)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
        raise
    os.replace(tmp, path)
    if fsync:
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def _write_members(tmp: str, arrays: dict, fsync: bool) -> None:
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
            for name, arr in arrays.items():
                shape, dtype = _member_meta(arr)
                with zf.open(f"{name}.npy", "w", force_zip64=True) as fp:
                    np.lib.format.write_array_header_2_0(
                        fp,
                        {
                            "descr": np.lib.format.dtype_to_descr(dtype),
                            "fortran_order": False,
                            "shape": shape,
                        },
                    )
                    for chunk in _iter_chunks(arr, shape, dtype):
                        if chunk.size == 0:
                            continue
                        mv = memoryview(chunk)
                        fp.write(mv.cast("B") if chunk.ndim else mv)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
