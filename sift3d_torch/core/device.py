"""Where the port runs, and the f32 numerics it pins there."""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The torch.device an entry point runs on.

    device: anything torch.device accepts; None means the device of `like`
    when it is a tensor, else the CPU. Nothing is picked for the caller:
    asking for a CUDA device without one raises in PyTorch, and the CPU
    runs only when asked for (or implied by a CPU tensor).

    On CUDA this switches TF32 off for cuBLAS matmuls and cuDNN
    convolutions. PyTorch's cuDNN default is TF32 for f32 convolutions;
    TF32 in the Gaussian blur flips tie-margin extrema (the JAX package
    needed full-f32 blur matmuls for parity). The port computes in f32
    only.
    """
    if device is None:
        dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
