"""Where the port runs, and the f32 numerics it pins there."""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The torch.device an entry point runs on.

    device: anything torch.device accepts. None means the card: the device
    of `like` when it is a CUDA tensor, else the current CUDA device, for a
    numpy array and a CPU tensor alike; without a CUDA card it raises. The
    CPU runs only when the caller asks for it (device="cpu").

    On CUDA this switches TF32 off for cuBLAS matmuls and cuDNN
    convolutions. PyTorch's cuDNN default is TF32 for f32 convolutions;
    TF32 in the Gaussian blur flips tie-margin extrema (the JAX package
    needed full-f32 blur matmuls for parity). The port computes in f32
    only.
    """
    if device is not None:
        dev = torch.device(device)
    elif isinstance(like, torch.Tensor) and like.device.type == "cuda":
        dev = like.device
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        raise RuntimeError(
            "the port runs on a CUDA card and found none; pass device=\"cpu\" to run "
            "the kernels' plain versions on the CPU"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
