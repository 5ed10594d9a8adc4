"""The benchmark's plain reference, which decides ``correct``.

An implementation of its own, written from the algorithm of the
repository's JAX package (``sift3d/``, which follows the Toews 3D SIFT
binaries), as plain NumPy with PyTorch's CPU matmul and max pool where a
whole volume is touched. It imports neither that package nor the program
(``sift3d_torch``), takes nothing the program made, and runs on the host
CPU, after the window, on the inputs the benchmark made:

- ``extract.features``: the features of one volume (``featExtract`` at the
  default configuration, GoH descriptors);
- ``match.group``: a group call of ``featmatch -r -s4 -n<k> --all-to-all
  --refine`` on ``.key`` files, read with ``keyparse.read_key``.

Each takes ``control=True`` for the control: the same computed one
precision step below the configuration's (see each module).
"""
