"""Pure-numpy NIfTI-1 reader/writer.

Copy of subcort_tpu/io/nifti.py, kept in the port so that it imports
nothing of the JAX package; tests/test_torch_io.py holds the two to the
same files. The reference uses nibabel for all volume I/O
(cnn_cort/base.py:4-5,145,357). This framework ships its own dependency-free NIfTI-1 implementation: a single
348-byte header + optional extensions + voxel data, stored x-fastest
(Fortran order), optionally gzipped. Covers everything the segmentation
pipeline needs:

- read/write ``.nii`` and ``.nii.gz``, plus two-file ``.hdr``/``.img``
  pairs (either member may be named, either/both may be gzipped) — the
  other NIfTI-1 storage form nibabel accepts wherever the reference loads
  a scan
- 3D and 4D volumes (the 15-channel prior atlas is 4D, base.py:529)
- dtype mapping for the codes that occur in MRI practice
- ``scl_slope``/``scl_inter`` scaling on read
- qform/sform affines (with the reference's relaxed quaternion tolerance,
  nets.py:17) and affine-preserving writes

The C++ registration tools in ``native/src/nifti_io.*`` implement the same
subset so both runtimes agree on the byte format.

The write path differs from the JAX copy's in speed only: a reader gets
the same bytes back (a plain ``.nii`` is byte-identical). A volume whose
memory already lies in file order (``data.T`` C-contiguous, as
:func:`load_nii` returns one) is written from that memory with no copy;
any other is transposed a few slabs at a time (``WRITES`` counts the two).
A ``.gz`` file is one gzip member at compresslevel 1, its voxels cut into
runs of about :data:`DEFLATE_CHUNK` bytes, each a raw-deflate segment
flushed to a byte boundary, so that ``gzip``, nibabel and zlib's
``gzread`` read it as they read any other; a write of several runs
deflates them on ``torch.get_num_threads()`` threads, one of a single run
on the calling thread (``DEFLATED_CHUNKS`` counts the runs).
"""

from __future__ import annotations

import collections
import gzip
import os
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# NIfTI-1 datatype codes -> numpy dtypes (the practical subset).
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"
_MAGIC_PAIR = b"ni1\x00"

# gzip's level for every write: nibabel's default, ~10x faster than the
# gzip module's own (9) on multi-hundred-MB probability maps
_GZ_LEVEL = 1
# voxel bytes a write takes at once; a .gz write of more is deflated on
# threads. A head's voxels cluster mid-volume and deflate far slower than the zero
# background around them, so chunks of a few MB spread a 28 MB volume's
# work over the threads where 8 MiB chunks left most of it in one
DEFLATE_CHUNK = 2 << 20
# the gzip member's header: magic, deflate, no flags; mtime; fastest (a
# level-1 stream); unknown OS (the gzip module's)
_GZ_MAGIC = b"\x1f\x8b\x08\x00"
_GZ_XFL_OS = b"\x04\xff"

# writes by the voxels' layout: "in_order" (streamed from memory) or
# "transposed" (a few slabs at a time); the runs deflated
WRITES = {"in_order": 0, "transposed": 0}
DEFLATED_CHUNKS = 0
# writers on several threads (the folder sweep's writer) count at once
_LOCK = threading.Lock()


def _pair_paths(path: str | os.PathLike):
    """If ``path`` names one member of a ``.hdr``/``.img`` pair, return
    ``(hdr_path, img_path)``; else None. The sibling is looked up both plain
    and gzipped (``nibabel`` accepts mixed compression across the pair)."""
    p = os.fspath(path)
    stem = p[:-3] if p.endswith(".gz") else p
    ext = stem[-4:]
    if ext.lower() not in (".hdr", ".img"):
        return None
    base = stem[:-4]

    def _find(e: str) -> str:
        # Probe the named member's case style first (legacy ANALYZE/SPM
        # datasets are often all-uppercase SCAN.HDR/SCAN.IMG), then the
        # other common spellings.
        styled = e.upper() if ext.isupper() else e
        for ce in dict.fromkeys((styled, e, e.upper())):
            for cand in (base + ce, base + ce + ".gz"):
                if os.path.exists(cand):
                    return cand
        return base + styled  # let open() raise the natural FileNotFoundError

    hdr = p if ext.lower() == ".hdr" else _find(".hdr")
    img = p if ext.lower() == ".img" else _find(".img")
    return hdr, img


def _open_maybe_gz(path: str | os.PathLike, mode: str):
    path = os.fspath(path)
    if path.endswith(".gz"):
        if "w" in mode:
            return gzip.open(path, mode, compresslevel=_GZ_LEVEL)
        return gzip.open(path, mode)
    return open(path, mode)


class NiftiImage:
    """An in-memory NIfTI volume: data array + affine + (raw) header fields.

    ``data`` has shape ``(X, Y, Z[, T...])`` — identical indexing convention
    to nibabel's ``get_data()`` that the reference relies on throughout.
    """

    def __init__(self, data: np.ndarray, affine: np.ndarray | None = None,
                 header: dict | None = None):
        self.data = np.asarray(data)
        if affine is None:
            affine = np.eye(4, dtype=np.float64)
        self.affine = np.asarray(affine, dtype=np.float64)
        self.header = dict(header or {})

    # nibabel-compatible conveniences used by reference-style code
    def get_data(self) -> np.ndarray:
        return self.data

    get_fdata = get_data

    @property
    def shape(self):
        return self.data.shape

    def to_filename(self, path: str | os.PathLike) -> None:
        save_nii(self, path)


def _quaternion_to_rotation(b: float, c: float, d: float) -> np.ndarray:
    """qform quaternion (b,c,d) -> 3x3 rotation; `a` recovered from unit norm.

    Applies the reference's relaxed tolerance for slightly-invalid headers
    (nets.py:17 lowers nibabel's quaternion_threshold): a small negative
    1-(b²+c²+d²) is clamped to 0 instead of raising.
    """
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ], dtype=np.float64)


def _rotation_to_quaternion(R: np.ndarray):
    """3x3 (proper) rotation -> quaternion (a,b,c,d), a >= 0."""
    t = np.trace(R)
    if t > 0:
        a = 0.5 * np.sqrt(1.0 + t)
        b = 0.25 * (R[2, 1] - R[1, 2]) / a
        c = 0.25 * (R[0, 2] - R[2, 0]) / a
        d = 0.25 * (R[1, 0] - R[0, 1]) / a
    else:
        # pick largest diagonal element for numerical stability
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = 2.0 * np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 0.0))
            b, c, d = 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
            a = (R[2, 1] - R[1, 2]) / s
        elif i == 1:
            s = 2.0 * np.sqrt(max(1.0 - R[0, 0] + R[1, 1] - R[2, 2], 0.0))
            b, c, d = (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s
            a = (R[0, 2] - R[2, 0]) / s
        else:
            s = 2.0 * np.sqrt(max(1.0 - R[0, 0] - R[1, 1] + R[2, 2], 0.0))
            b, c, d = (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s
            a = (R[1, 0] - R[0, 1]) / s
    if a < 0:
        a, b, c, d = -a, -b, -c, -d
    return a, b, c, d


def load_nii(path: str | os.PathLike) -> NiftiImage:
    """Read a ``.nii``/``.nii.gz`` file — or either member of a
    ``.hdr``/``.img`` pair — into a :class:`NiftiImage`."""
    pair = _pair_paths(path)
    with _open_maybe_gz(pair[0] if pair else path, "rb") as fh:
        raw = fh.read()
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr_be = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr_be == _HDR_SIZE:
            endian = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    def unpack(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    dim = unpack("8h", 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])

    datatype = unpack("h", 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    pixdim = unpack("8f", 76)
    vox_offset = int(unpack("f", 108)[0])
    scl_slope = unpack("f", 112)[0]
    scl_inter = unpack("f", 116)[0]
    qform_code = unpack("h", 252)[0]
    sform_code = unpack("h", 254)[0]
    quatern = unpack("3f", 256)          # b, c, d
    qoffset = unpack("3f", 268)          # x, y, z
    srow = np.array(unpack("12f", 280), dtype=np.float64).reshape(3, 4)
    magic = raw[344:348]

    # affine: prefer sform, then qform, then pixdim-scaled identity
    affine = np.eye(4, dtype=np.float64)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        R = _quaternion_to_rotation(*quatern)
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        Z = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
        affine[:3, :3] = R @ Z
        affine[:3, 3] = qoffset
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]

    n_items = int(np.prod(shape)) if shape else 0
    if pair:
        # two-file form: voxel data lives in the .img; vox_offset (usually 0)
        # is an offset into that file
        with _open_maybe_gz(pair[1], "rb") as fh:
            raw = fh.read()
        start = max(vox_offset, 0)
    else:
        start = max(vox_offset, _HDR_SIZE)
    if len(raw) < start + n_items * dtype.itemsize:
        raise ValueError(f"{path}: truncated NIfTI voxel data "
                         f"({len(raw)} bytes, need {start + n_items * dtype.itemsize})")
    data = np.frombuffer(raw, dtype=dtype, count=n_items, offset=start)
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * np.float32(slope) + np.float32(scl_inter)
    else:
        data = data.astype(dtype.newbyteorder("="))

    header = {
        "pixdim": tuple(float(p) for p in pixdim),
        "qform_code": int(qform_code),
        "sform_code": int(sform_code),
        "datatype": int(datatype),
        "magic": bytes(magic),
    }
    return NiftiImage(data, affine, header)


def _count(in_order: bool, chunks: int) -> None:
    global DEFLATED_CHUNKS
    with _LOCK:
        WRITES["in_order" if in_order else "transposed"] += 1
        DEFLATED_CHUNKS += chunks


def _deflate(raw, last: bool) -> bytes:
    """``raw`` as one raw-deflate segment at :data:`_GZ_LEVEL`, flushed to
    a byte boundary, or finished when it is the stream's ``last``."""
    c = zlib.compressobj(_GZ_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
    return c.compress(raw) + c.flush(zlib.Z_FINISH if last
                                     else zlib.Z_SYNC_FLUSH)


def _chunks(ft: np.ndarray, in_order: bool):
    """``(n, piece)``: ``piece(k)`` is the ``k``-th of ``n`` (at least one)
    runs of the voxel bytes in file order (C order of ``ft``):
    :data:`DEFLATE_CHUNK` bytes of the memory itself when ``in_order``,
    else whole slabs of ``ft`` copied out together, about as many bytes or
    one slab."""
    if in_order:
        flat = ft.reshape(-1).view(np.uint8)
        size = DEFLATE_CHUNK
        return (max(1, -(-flat.size // size)),
                lambda k: flat[k * size:(k + 1) * size])
    per = max(1, DEFLATE_CHUNK // ft[0].nbytes)
    return -(-ft.shape[0] // per), lambda k: np.ascontiguousarray(
        ft[k * per:(k + 1) * per]).reshape(-1).view(np.uint8)


def _deflated(n: int, piece):
    """``(raw, segment)`` for each of the ``n`` pieces in order, the last
    segment finishing the stream: one piece deflated on the calling
    thread, several on ``torch.get_num_threads()`` threads with at most
    two pieces a thread in flight."""
    def work(k):
        raw = piece(k)
        return raw, _deflate(raw, k == n - 1)

    if n == 1:
        yield work(0)
        return
    threads = max(1, torch.get_num_threads())
    with ThreadPoolExecutor(threads) as pool:
        pending = collections.deque()
        for k in range(n):
            while len(pending) < 2 * threads and k + len(pending) < n:
                pending.append(pool.submit(work, k + len(pending)))
            yield pending.popleft().result()


def _write_file(path: str, head: bytes, data: np.ndarray) -> None:
    """Write ``head`` then ``data``'s voxels in file order (x fastest) to
    ``path`` without a second full-volume copy: F-order bytes of ``data``
    are the C-order bytes of ``data.T``, taken from memory when they lie
    so, else a few slabs of ``data.T`` at a time (:func:`_chunks`). A
    ``.gz`` path gets one gzip member: its header, the pieces' segments in
    order (:func:`_deflated`) while this thread checksums them, and one
    CRC-32 and size trailer."""
    ft = data.T if data.ndim > 1 else data.reshape(1, -1)
    in_order = ft.flags.c_contiguous
    n, piece = _chunks(ft, in_order)
    gz = path.endswith(".gz")
    with open(path, "wb") as fh:
        if not gz:
            fh.write(head)
            for k in range(n):
                fh.write(piece(k))
        else:
            fh.write(_GZ_MAGIC + struct.pack("<I", int(time.time()))
                     + _GZ_XFL_OS)
            fh.write(_deflate(head, False))
            crc, size = zlib.crc32(head), len(head)
            for raw, segment in _deflated(n, piece):
                crc = zlib.crc32(raw, crc)
                size += raw.nbytes
                fh.write(segment)
            fh.write(struct.pack("<II", crc, size & 0xFFFFFFFF))
    _count(in_order, n if gz else 0)


def save_nii(img: NiftiImage | np.ndarray, path: str | os.PathLike,
             affine: np.ndarray | None = None) -> None:
    """Write a NIfTI-1 file: single ``.nii``/``.nii.gz``, or a two-file
    ``.hdr``/``.img`` pair when ``path`` names either member (the sibling is
    written alongside with the same compression)."""
    if isinstance(img, np.ndarray):
        img = NiftiImage(img, affine)
    data = np.asarray(img.data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    dt = np.dtype(data.dtype).newbyteorder("=")
    if np.dtype(dt) not in _DTYPE_CODES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    code = _DTYPE_CODES[np.dtype(dt)]

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)

    affine = np.asarray(img.affine, dtype=np.float64)
    # voxel sizes from the affine columns
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    zooms[zooms == 0] = 1.0
    pixdim = [1.0] + list(zooms[:3]) + [0.0] * 4

    # derive a qform too so strict readers are happy; fall back to sform-only
    # for non-orthogonal affines.
    R = affine[:3, :3] / zooms
    qfac = 1.0
    if np.linalg.det(R) < 0:
        qfac = -1.0
        R = R @ np.diag([1.0, 1.0, -1.0])
    try:
        # orthonormalize (closest rotation) for the quaternion
        u, _, vt = np.linalg.svd(R)
        Rq = u @ vt
        _, qb, qc, qd = _rotation_to_quaternion(Rq)
        qform_code = 1
    except np.linalg.LinAlgError:
        qb = qc = qd = 0.0
        qform_code = 0
    pixdim[0] = qfac

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    hdr[38] = ord("r")  # regular
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, dt.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    # honor caller-provided intensity scaling (clinical int16 + scl_slope
    # encoding: stored = (value - scl_inter) / scl_slope; readers — ours
    # included, see load above — reconstruct value = stored * slope + inter)
    struct.pack_into("<f", hdr, 112, float(img.header.get("scl_slope", 1.0)))
    struct.pack_into("<f", hdr, 116, float(img.header.get("scl_inter", 0.0)))
    struct.pack_into("<b", hdr, 123, 10)     # xyzt_units: mm | sec
    struct.pack_into("<h", hdr, 252, qform_code)
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = 1 (scanner)
    struct.pack_into("<3f", hdr, 256, qb, qc, qd)
    struct.pack_into("<3f", hdr, 268, affine[0, 3], affine[1, 3], affine[2, 3])
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    p = os.fspath(path)
    stem = p[:-3] if p.endswith(".gz") else p
    gz = ".gz" if p.endswith(".gz") else ""
    ext = stem[-4:]
    if ext.lower() in (".hdr", ".img"):
        base = stem[:-4]
        # keep the exact name the caller passed; the sibling follows its
        # case style (SCAN.IMG -> SCAN.HDR, scan.img -> scan.hdr)
        hdr_ext = ext if ext.lower() == ".hdr" else (".HDR" if ext.isupper() else ".hdr")
        img_ext = ext if ext.lower() == ".img" else (".IMG" if ext.isupper() else ".img")
        struct.pack_into("<f", hdr, 108, 0.0)  # vox_offset is into the .img
        hdr[344:348] = _MAGIC_PAIR
        with _open_maybe_gz(base + hdr_ext + gz, "wb") as fh:
            fh.write(bytes(hdr))
        _write_file(base + img_ext + gz, b"", data)
        return

    hdr[344:348] = _MAGIC_SINGLE
    _write_file(p, bytes(hdr) + b"\x00" * 4, data)
