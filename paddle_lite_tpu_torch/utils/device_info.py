"""Device discovery — analog of ``lite/core/device_info.{h,cc}``.

Port of ``paddle_lite_tpu/utils/device_info.py`` (``:35-81``): the device's
identity, the peak figures the roofline reports divide by, and its memory
occupancy.  :func:`get` reads ``torch.cuda.get_device_properties`` and
looks the card's name up in :data:`SPECS`, which holds public figures
(NVIDIA's data sheet, H100 SXM, dense rates): HBM 3.35 TB/s, int8 tensor
cores 1,979 TOP/s, bf16 989 TFLOP/s, and fp32 outside the tensor cores as
instructions, 132 SMs × 128 lanes × 1,980 MHz.  Those rates assume the
card's full 700 W; a card set below it runs slower under load.  A card
whose name is not in the table raises: no other card's figures stand in
for it.  The ``"cpu"`` entry keeps the reference's nominal figures, for
analysis on a host without a card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from ..core.device import DeviceLike, resolve_device

# name fragment (lower case) -> peak figures: tera-operations a second,
# GB/s, GB of device memory
SPECS: Dict[str, Dict[str, float]] = {
    "h100 80gb hbm3": {"int8_tops": 1979.0, "bf16_tflops": 989.0,
                       "fp32_tinstrs": 132 * 128 * 1.98e9 / 1e12,
                       "hbm_gbps": 3350.0, "hbm_gb": 80.0, "sms": 132.0},
    "cpu": {"int8_tops": 1.0, "bf16_tflops": 0.5, "fp32_tinstrs": 0.25,
            "hbm_gbps": 50.0, "hbm_gb": 8.0, "sms": 0.0},
}


def specs_for(name: str) -> Dict[str, float]:
    """The figures of the device called `name`; raises for a name no entry
    of :data:`SPECS` is part of."""
    low = name.lower()
    for key, s in SPECS.items():
        if key in low:
            return s
    raise KeyError(f"device_info: no figures for {name!r} (known: {sorted(SPECS)}); "
                   f"add the card's published peaks to SPECS")


@dataclasses.dataclass
class DeviceInfo:
    platform: str  # "gpu" or "cpu"
    device_kind: str
    num_devices: int
    specs: Dict[str, float]
    sm_count: Optional[int] = None
    total_memory: Optional[int] = None  # bytes

    def peak_int8_tops(self) -> float:
        return self.specs["int8_tops"]

    def peak_hbm_gbps(self) -> float:
        return self.specs["hbm_gbps"]

    def hbm_bytes_per_s(self) -> float:
        return self.specs["hbm_gbps"] * 1e9

    def int8_ops_per_s(self) -> float:
        return self.specs["int8_tops"] * 1e12

    def fp32_instrs_per_s(self) -> float:
        return self.specs["fp32_tinstrs"] * 1e12

    def roofline_time_s(self, flops: float, bytes_moved: float,
                        int8: bool = True) -> float:
        """max(compute, memory) time — the roofline lower bound."""
        peak = (self.specs["int8_tops"] if int8 else self.specs["bf16_tflops"]) * 1e12
        return max(flops / peak, bytes_moved / self.hbm_bytes_per_s())


@functools.lru_cache(maxsize=None)
def _get(device: torch.device) -> DeviceInfo:
    if device.type != "cuda":
        return DeviceInfo("cpu", "cpu", 1, SPECS["cpu"])
    props = torch.cuda.get_device_properties(device)
    return DeviceInfo("gpu", props.name, torch.cuda.device_count(), specs_for(props.name),
                      sm_count=props.multi_processor_count,
                      total_memory=props.total_memory)


def get(device: DeviceLike = None) -> DeviceInfo:
    """The device's identity and figures: the card unless ``device="cpu"``
    is asked for (with no card, the default raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _get(dev)


def memory_stats(device: DeviceLike = None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of the card; None on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.memory_stats(dev) if dev.type == "cuda" else None
