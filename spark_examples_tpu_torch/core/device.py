"""Device selection: CUDA unless the caller asks for the CPU.

A job asked to run on ``cuda`` where no CUDA device is visible raises;
it never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` | ``"cpu"`` -> a ``torch.device``, raising when CUDA is
    asked for and absent."""
    if name not in DEVICES:
        raise ValueError(
            f"bad device {name!r} — expected one of {' | '.join(DEVICES)}"
        )
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible to torch "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}) — run on a GPU host, or pass "
            "--device cpu for the plain PyTorch path"
        )
    return torch.device(name)
