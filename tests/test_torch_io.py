"""PyTorch port: its own NIfTI module against the JAX package's.

``subcort_tpu_torch.io`` is a copy of ``subcort_tpu.io``, kept so that the
port imports nothing of the JAX package. A file written by one package is
read back by the other, both ways, with the same data, dtype and affine;
plain ``.nii`` files are byte-identical (``.nii.gz`` carries a gzip time
stamp).
"""

import numpy as np
import pytest

from subcort_tpu.io import NiftiImage as JaxNiftiImage
from subcort_tpu.io import load_nii as jax_load_nii
from subcort_tpu.io import save_nii as jax_save_nii
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii

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
