"""The devices a Z-sharded volume lives on.

The port's counterpart of ``sift3d.dist.mesh`` for the "space" axis: a
mesh is an ordered list of torch devices, shard i on ``mesh[i]``. There is
one controlling process, as in the JAX package: the shards are tensors of
one program, and a halo moves between cards with ``.to(device)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def make_mesh(space: Optional[int] = None, devices: Optional[Sequence] = None) -> List[torch.device]:
    """`space` shards over `devices`, in order, cycling through the list
    when it is shorter (so ["cpu"] or ["cuda:0"] holds every shard on one
    device, as the JAX tests simulate 8 devices on one CPU).

    devices None: every CUDA device (``jax.devices()``'s counterpart); it
    raises without one. space None: one shard per device.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh of CUDA devices needs a CUDA card; pass devices=[\"cpu\"]")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n = len(devices) if space is None else int(space)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {space}")
    return [devices[i % len(devices)] for i in range(n)]
