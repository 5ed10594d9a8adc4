"""sift3d_torch: the 3D SIFT engine on PyTorch with hand-written CUDA kernels.

A port of the JAX package ``sift3d`` (the reference it is tested against),
laid out like it:

- :mod:`sift3d_torch.core`      configuration, FeatureSet, device choice
- :mod:`sift3d_torch.io`        NIfTI-1 reader/writer, .key feature files
- :mod:`sift3d_torch.kernels`   blur, resampling, extrema, patch helpers,
                                descriptors, and the CUDA kernel wrappers
- :mod:`sift3d_torch.pipeline`  pyramid, feature stage, extraction
- :mod:`sift3d_torch.match`     kNN, ratio test, Hough vote, similarity
                                fit, group soft vote, transforms
- :mod:`sift3d_torch.dist`      Z-sharded extraction, placement over many
                                volumes, the sharded kNN and solve, several
                                processes
- :mod:`sift3d_torch.cli`       the featextract and featmatch command lines
- ``csrc/``                     CUDA C++ sources (sm_90a), built on first use

It never imports ``jax`` or ``sift3d``. The extraction entry points are
exported here: ``extract_features`` (one volume),
``extract_features_many`` (a list of volumes, same-shape ones batched)
and ``extract_features_batch`` (a list of volumes placed over a mesh of
devices, ``sift3d_torch.dist.batch``); ``Scan``, a volume with its voxel
size and world matrix, is their input under ``prescale="isotropic"``
(featExtract's -w).
"""

from sift3d_torch.dist.batch import extract_features_batch  # noqa: F401
from sift3d_torch.pipeline.extract import Scan, extract_features, extract_features_many  # noqa: F401
