"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``).

A wrapper runs its kernel's plain PyTorch version only for tensors that
lie on the CPU; a CUDA tensor launches the kernel or raises.
"""

import torch


def on_cuda() -> bool:
    """True when a CUDA device is present."""
    return torch.cuda.is_available()


def require_cuda(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device."""
    if t.device.type != "cuda":
        raise RuntimeError(
            f"kernel input lies on {t.device}; the kernel runs on CUDA "
            "tensors only (CPU tensors take the plain PyTorch version)")
