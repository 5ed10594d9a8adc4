"""sift3d_torch: the 3D SIFT engine on PyTorch with hand-written CUDA kernels.

A port of the JAX package ``sift3d`` (the reference it is tested against),
laid out like it:

- :mod:`sift3d_torch.core`      configuration, FeatureSet, device choice
- :mod:`sift3d_torch.io`        NIfTI-1 reader/writer, .key feature files
- :mod:`sift3d_torch.kernels`   blur, resampling, extrema, patch helpers,
                                descriptors, and the CUDA kernel wrappers
- :mod:`sift3d_torch.pipeline`  pyramid, feature stage, extraction
- :mod:`sift3d_torch.cli`       the featextract command line
- ``csrc/``                     CUDA C++ sources (sm_90a), built on first use

It never imports ``jax`` or ``sift3d``.
"""
