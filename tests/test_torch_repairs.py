"""Two repaired faults of the port.

1. The ``"torch"`` int8 conv is exact for any K = kh·kw·C.  One fp32 conv
   is exact only while every partial sum stays below 2^24, which holds for
   every input up to K = 1040 (``ops/nn.FP32_EXACT_K``); past it the route
   sums input-channel chunks of K ≤ 1040, each rounded, in int32.  Held to
   the reference's accumulator on its target, ``jax.lax.conv_general_
   dilated(..., preferred_element_type=jnp.int32)``, converted once to fp32
   (not to the reference's CPU output, itself an fp32 conv and ``round``):
   bit for bit, no tolerance.
2. ``csrc/dw_conv.cu`` keeps the card's numbers per device: a table with
   one entry a device index, filled by ``plt_dw_conv_prepare`` for the
   device it runs on, read by the layout and the launch for the current
   device (the wrapper makes it the tensor's).  The source is checked here
   (no nvcc on the CPU), the wrapper's per-device prepare and layout with a
   stand-in library.
"""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_lite_tpu_torch as P
from paddle_lite_tpu_torch.core.ir import Graph
from paddle_lite_tpu_torch.core.types import Precision, QuantInfo
from paddle_lite_tpu_torch.ops import nn
from paddle_lite_tpu_torch.ops.kernels import _build, depthwise

CPU = torch.device("cpu")


def _torch_conv(x, w, *, stride=1, pads=(1, 1), dilation=1, groups=1):
    """One int8 conv2d on the "torch" route, scale 1, no bias, fp32 out."""
    n, h, wd, _ = x.shape
    kh, kw, _, oc = w.shape
    g = Graph("t")
    g.add_var("x", x.shape, precision=Precision.INT8).quant = QuantInfo.per_tensor(1.0)
    g.inputs.append("x")
    g.add_weight("w", w).quant = QuantInfo.per_channel_scales(np.ones(oc, np.float32), 3)
    ek, ekw = dilation * (kh - 1) + 1, dilation * (kw - 1) + 1
    oh = (h + 2 * pads[0] - ek) // stride + 1
    ow = (wd + 2 * pads[1] - ekw) // stride + 1
    g.add_var("y", (n, oh, ow, oc))
    g.outputs.append("y")
    g.add_op("conv2d", {"Input": ["x"], "Filter": ["w"]}, {"Output": ["y"]},
             {"strides": [stride, stride], "paddings": list(pads),
              "dilations": [dilation, dilation], "groups": groups, "enable_int8": True})
    g.rebuild_links()
    return P.build_callable(g, device=CPU)(P.stage_weights(g, CPU), {"x": x})["y"].numpy()


def _int32_acc(x, w, *, stride=1, pads=(1, 1), dilation=1):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(stride, stride),
        padding=((pads[0], pads[0]), (pads[1], pads[1])),
        rhs_dilation=(dilation, dilation), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


def test_fp32_exact_k_is_the_largest_exact_k():
    assert nn.FP32_EXACT_K * 127 ** 2 < 2 ** 24 <= (nn.FP32_EXACT_K + 1) * 127 ** 2


def test_saturating_k4608_is_exact_on_the_torch_route():
    """x and w of one sign in 100..127 at C = 512 (K = 4608): the
    accumulator passes 2^25; the torch route gives the exact accumulator
    rounded once to fp32, where one fp32 conv and ``round`` is off."""
    rng = np.random.default_rng(11)
    x = rng.integers(100, 128, size=(1, 5, 5, 512), dtype=np.int8)
    w = rng.integers(100, 128, size=(3, 3, 512, 8), dtype=np.int8)
    acc = _int32_acc(x, w)
    assert acc.max() > 2 ** 25
    np.testing.assert_array_equal(_torch_conv(x, w), acc.astype(np.float32))
    one = np.round(torch.nn.functional.conv2d(
        torch.from_numpy(x).float().permute(0, 3, 1, 2),
        torch.from_numpy(w).float().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
        .numpy())
    assert (one != acc.astype(np.float32)).any()  # the fault this route repairs


@pytest.mark.parametrize("k,c,stride,pads,dilation", [
    (1, 1041, 1, (0, 0), 1),   # K just above 1040: two chunks, 1040 + 1
    (3, 117, 1, (1, 1), 1),    # K = 1053: chunks of 115 and 2 channels
    (3, 300, 2, (1, 1), 1),    # 115 + 115 + 70: no chunk boundary divides C
    (5, 77, 1, (2, 2), 1),     # K = 1925, chunks of 41 + 36
    (3, 200, 1, (2, 2), 2),    # dilated
])
def test_chunked_conv_is_the_int32_accumulator(k, c, stride, pads, dilation):
    rng = np.random.default_rng(k * 1000 + c)
    x = rng.integers(-127, 128, size=(2, 7, 6, c), dtype=np.int8)
    w = rng.integers(-127, 128, size=(k, k, c, 5), dtype=np.int8)
    x[0, :3] = 127  # push some sums far past 2^24
    w[..., 0] = 127
    acc = _int32_acc(x, w, stride=stride, pads=pads, dilation=dilation)
    got = _torch_conv(x, w, stride=stride, pads=pads, dilation=dilation)
    np.testing.assert_array_equal(got, acc.astype(np.float32))


def test_grouped_conv_past_the_exact_k_raises():
    x = np.zeros((1, 4, 4, 240), np.int8)
    w = np.zeros((3, 3, 120, 8), np.int8)  # 2 groups, K = 1080 a group
    with pytest.raises(NotImplementedError, match="not exact"):
        _torch_conv(x, w, groups=2)


# ---- dw_conv.cu: per-device state -------------------------------------------

def test_dw_conv_source_keeps_the_card_per_device():
    src = (_build.CSRC / "dw_conv.cu").read_text()
    # no scalar process globals for the card's numbers
    assert not re.search(r"\bint\s+g_\w+\s*=", src)
    assert "Card g_cards[MAX_DEVICES]" in src
    prep = src[src.index('extern "C" int plt_dw_conv_prepare'):]
    prep = prep[:prep.index("\n}\n")]
    assert "cudaGetDevice(&dev)" in prep and "g_cards[dev] = c" in prep
    for entry in ('extern "C" int plt_dw_conv_layout', 'extern "C" int plt_dw_conv('):
        body = src[src.index(entry):]
        body = body[:body.index("\n}\n")]
        assert "current_card()" in body and "card->" in body
        assert "cudaDeviceGetAttribute" not in body and "cudaFuncSetAttribute" not in body
    cur = src[src.index("Card* current_card()"):]
    assert "cudaGetDevice" in cur[:cur.index("\n}\n")]


class _FakeLib:
    """The dw_conv library as a card pair with 10 and 100 SMs would report."""

    def __init__(self):
        self.device, self.prepared = 0, []

    def plt_dw_conv_prepare(self):
        self.prepared.append(self.device)
        return 0

    def plt_dw_conv_layout(self, k, threads, channels, bps, sms, smem):
        if self.device not in self.prepared:
            return 1  # the library refuses a device it has no entry for
        base = 100 * self.device
        for ref, v in ((threads, 256), (channels, 4), (bps, 2), (sms, 10 + base),
                       (smem, 50_000 + base)):
            ref._obj.value = v
        return 0


def test_dw_conv_prepare_and_layout_per_device(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "_LIBS", {"dw_conv": lib})
    monkeypatch.setattr(_build, "_PREPARED", set())

    @contextlib.contextmanager
    def on(device):
        prev, lib.device = lib.device, device
        yield
        lib.device = prev

    monkeypatch.setattr(torch.cuda, "device", on)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: lib.device)
    depthwise._layout.cache_clear()
    try:
        a, b = depthwise.layout(3, device=1), depthwise.layout(5, device=0)
        assert (a.sms, b.sms) == (110, 10)  # each read from its own device's entry
        assert lib.prepared == [1, 0]       # each device prepared, once
        depthwise.layout(5, device=1)
        assert lib.prepared == [1, 0]
    finally:
        depthwise._layout.cache_clear()
