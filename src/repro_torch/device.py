"""Device resolution for the port's entry points.

Every entry point runs on CUDA unless the caller asks for ``"cpu"``.  Asking
for CUDA where there is none raises: no path falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, checked and configured.

    On CUDA this turns TF32 off for matmuls and cuDNN convolutions: cuDNN
    runs float32 convolutions in TF32 by default, which keeps about three
    decimal digits and would drift the Eq. 5 cosines and the Alg. 3 signs
    away from the float32 reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass 'cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
