"""Device choice and fp32 arithmetic settings shared by the entry points.

The entry points (``tools.opt.optimize``, ``runtime.predictor``) run on the
card unless the caller asks for the CPU: ``device=None`` means ``"cuda"``,
and with no card that raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_TF32_LOCK = threading.Lock()
_tf32_users = 0
_tf32_saved = (True, False)


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """Full fp32 for convs and matmuls (TF32 off) while any run is inside.

    The reference's fp32 paths (stem conv, calibration, fp32 predictor,
    softmax) are full fp32; cuDNN convolutions default to TF32 on Hopper,
    which keeps about three decimal digits and would move the calibrated
    scales and the outputs.  The flags are process-wide, so runs on several
    threads share one count: the first to enter saves and clears them, the
    last to leave restores them.
    """
    global _tf32_users, _tf32_saved
    with _TF32_LOCK:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """numpy array / tensor -> tensor on `device` (no copy if already there)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)
