"""PyTorch port: its own NIfTI module against the JAX package's.

``subcort_tpu_torch.io`` is a copy of ``subcort_tpu.io``, kept so that the
port imports nothing of the JAX package. A file written by one package is
read back by the other, both ways, with the same data, dtype and affine;
plain ``.nii`` files are byte-identical (``.nii.gz`` carries a gzip time
stamp). The port's writer streams a volume that lies in file order from
its memory and deflates a large ``.gz`` write in chunks on threads; its
files decompress to the same bytes whatever the layout and chunking.
"""

import gzip
import zlib

import numpy as np
import pytest

from subcort_tpu.io import NiftiImage as JaxNiftiImage
from subcort_tpu.io import load_nii as jax_load_nii
from subcort_tpu.io import save_nii as jax_save_nii
from subcort_tpu_torch.io import NiftiImage, load_nii, nifti, save_nii

AFFINE = np.array([[-1.2, 0.0, 0.1, 90.0],
                   [0.0, 0.9, 0.0, -126.5],
                   [0.05, 0.0, 1.1, -72.0],
                   [0.0, 0.0, 0.0, 1.0]])

PACKAGES = {"port": (NiftiImage, load_nii, save_nii),
            "jax": (JaxNiftiImage, jax_load_nii, jax_save_nii)}


def _volume(rng, dtype, channels):
    shape = (9, 7, 6) + ((15,) if channels else ())
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("channels", [False, True], ids=["3d", "4d15"])
@pytest.mark.parametrize("dtype", ["int16", "uint8", "float32"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_nifti_round_trip_across_packages(tmp_path, rng, writer, reader,
                                          dtype, channels, ext):
    data = _volume(rng, dtype, channels)
    image_cls, _, save = PACKAGES[writer]
    path = tmp_path / f"vol{ext}"
    save(image_cls(data, AFFINE), str(path))
    got = PACKAGES[reader][1](str(path))
    assert got.data.dtype == data.dtype and got.data.shape == data.shape
    np.testing.assert_array_equal(got.data, data)
    np.testing.assert_array_equal(got.affine,
                                  PACKAGES[writer][1](str(path)).affine)
    np.testing.assert_allclose(got.affine, AFFINE, atol=1e-5)
    if ext == ".nii":
        other = tmp_path / f"other{ext}"
        reader_cls, _, reader_save = PACKAGES[reader]
        reader_save(reader_cls(data, AFFINE), str(other))
        assert other.read_bytes() == path.read_bytes()


def _layout(rng, layout, channels):
    """A float32 volume of (9, 7, 6[, 15]) laid out F-contiguous,
    C-contiguous, or as a strided slice of a larger C-ordered array."""
    shape = (9, 7, 6) + ((15,) if channels else ())
    if layout == "sliced":
        big = rng.standard_normal((18, 7, 8) + shape[3:]).astype(np.float32)
        data = big[::2, :, 1:7]
        assert not (data.flags.c_contiguous or data.flags.f_contiguous)
        return data
    data = rng.standard_normal(shape).astype(np.float32)
    return np.asfortranarray(data) if layout == "F" else data


@pytest.mark.parametrize("ext,chunk", [(".nii", None), (".nii.gz", None),
                                       (".nii.gz", 256), (".nii", 256)],
                         ids=["nii", "gz-one-chunk", "gz-chunks",
                              "nii-chunks"])
@pytest.mark.parametrize("channels", [False, True], ids=["3d", "4d15"])
@pytest.mark.parametrize("layout", ["F", "C", "sliced"])
def test_save_nii_streams_file_order_in_one_member(tmp_path, rng,
                                                   monkeypatch, layout,
                                                   channels, ext, chunk):
    """Every layout, written plain or gzipped, whole or in chunks (the
    chunk constant cut to 256 bytes): the voxel stream is the volume's
    F-order bytes; a ``.gz`` file is one gzip member; both packages read
    it back bit-equal; a plain file is the JAX package's byte for byte;
    the counters record the layout's path and the chunks deflated (a
    plain file's none)."""
    data = _layout(rng, layout, channels)
    if chunk is not None:
        monkeypatch.setattr(nifti, "DEFLATE_CHUNK", chunk)
    writes, chunks = dict(nifti.WRITES), nifti.DEFLATED_CHUNKS
    path = tmp_path / f"vol{ext}"
    save_nii(NiftiImage(data, AFFINE), str(path))

    raw = path.read_bytes()
    if ext == ".nii.gz":
        member = zlib.decompressobj(31)
        stream = member.decompress(raw)
        assert member.eof and member.unused_data == b""
        assert gzip.decompress(raw) == stream
    else:
        stream = raw
    assert stream[352:] == data.tobytes(order="F")
    for load in (load_nii, jax_load_nii):
        got = load(str(path)).data
        assert got.dtype == data.dtype
        np.testing.assert_array_equal(got, data)
    if ext == ".nii":
        other = tmp_path / "jax.nii"
        jax_save_nii(JaxNiftiImage(data, AFFINE), str(other))
        assert other.read_bytes() == raw

    path_taken = "in_order" if layout == "F" else "transposed"
    assert nifti.WRITES[path_taken] == writes[path_taken] + 1
    assert sum(nifti.WRITES.values()) == sum(writes.values()) + 1
    n = nifti.DEFLATED_CHUNKS - chunks
    if ext == ".nii":
        assert n == 0
    elif chunk is None:
        assert n == 1
    elif layout == "F":
        assert n == -(-data.nbytes // chunk)
    else:
        assert n > 1
