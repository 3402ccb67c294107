"""Volume I/O: the port's own copy of the JAX package's NIfTI-1 module."""

from subcort_tpu_torch.io.nifti import NiftiImage, load_nii, save_nii  # noqa: F401
