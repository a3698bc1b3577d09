"""The int8 GEMM kernel's tiling plan and the wrappers' device rule, on the CPU.

``ops/kernels/int8_matmul.plan`` is pure Python: it is held here to what
``csrc/int8_gemm.cu`` needs at every GEMM shape of the MobileNetV1,
SSD-MobileNetV1 and MobileNetV3 paths, read off the port's own graphs at
the sizes ``chip_smoke.py`` runs (b64 / 224 px, b32 / 300 px).  The kernel
itself is checked against its plain version on the card (``chip_smoke.py``
and ``tests/test_torch_kernels.py``); its epilogue's conversion-free
arithmetic (``small_int_to_float``, ``plt::requant_lo``) is checked here in
float32, bit for bit.  The rule that every
wrapper launches only on the current CUDA device is checked on device
indices; a run with two cards is not possible on a one-card machine.
"""

import contextlib

import numpy as np
import pytest
import torch

from paddle_lite_tpu_torch.core.pass_manager import PassManager
from paddle_lite_tpu_torch.models import mobilenet_v1, mobilenet_v3, resnet, ssd
from paddle_lite_tpu_torch.ops.kernels import _build, depthwise
from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km
from paddle_lite_tpu_torch.ops.kernels.select import gemm_eligible
from paddle_lite_tpu_torch.tools import gen_wgmma_s8
from paddle_lite_tpu_torch.tools.opt import FUSION_PASSES

SMEM_BLOCK = 227 * 1024  # shared bytes a block may take on an H100 (232,448)

PATHS = {
    "mobilenet_v1": lambda: mobilenet_v1.build(batch=64, image_size=224, seed=0),
    "ssd": lambda: ssd.build(batch=32, image_size=300, num_classes=21, seed=0),
    "mobilenet_v3": lambda: mobilenet_v3.build(batch=64, image_size=224, seed=0,
                                               with_softmax=False),
    "resnet": lambda: resnet.build(batch=32, image_size=224, seed=0),
}


def gemm_shapes(g):
    """(M, K, N) of every op of the unoptimized `g` that the GEMM kernel
    takes once marked int8 (residuals are not fused yet, so the convs that
    will carry one count too), as chip_smoke's ``kernel_shapes`` reads
    them: a conv's M is N·OH·OW, its K kh·kw·C."""
    out = []
    for op in g.topological_order():
        op.attrs["enable_int8"] = True
        if not gemm_eligible(g, op):
            continue
        if op.op_type == "conv2d":
            n, oh, ow, oc = g.vars[op.output("Output")].shape
            out.append((n * oh * ow, int(np.prod(g.vars[op.input("Filter")].shape[:3])), oc))
        elif op.op_type == "fc":
            x = g.vars[op.input("Input")].shape
            ncd = int(op.attrs.get("in_num_col_dims", len(x) - 1))
            k, n = g.vars[op.input("W")].shape
            out.append((int(np.prod(x[:ncd])), k, n))
    return out


@pytest.mark.parametrize("path,count", [("mobilenet_v1", 14), ("ssd", 33),
                                        ("mobilenet_v3", 48), ("resnet", 53)])
def test_plan_fits_every_path_shape(path, count):
    shapes = gemm_shapes(PATHS[path]())
    # MNv3: 38 take the kernel, 10 get residuals; ResNet-50: 37 and 16
    assert len(shapes) == count
    for m, k, n in shapes:
        for out_i8 in (True, False):
            p = km.plan(m, k, n, out_i8)
            bm = 64 * p.warpgroups
            es = 1 if out_i8 else 4
            assert p.smem_bytes <= SMEM_BLOCK
            assert p.smem_bytes == km.smem_bytes(bm, p.bn, p.bk, out_i8)
            assert p.tiles == -(-m // bm) * -(-n // p.bn)  # the tiles cover M x N
            assert p.bn in km.BN_CHOICES
            if n <= 256 and m >= 64 * km.SMS:  # A is read from device memory once
                assert p.bn >= n, (m, k, n, p)
            elif n <= 256:  # fewer row tiles than SMs: narrower tiles spread them
                assert p.bn >= n or p.tiles <= 2 * km.SMS, (m, k, n, p)
            assert p.bk in (32, 64, 128) and p.bk % 32 == 0
            assert k % p.width == 0 and p.bk % p.width == 0
            assert (n * es) % p.out_width == 0 and (p.bn * es) % p.out_width == 0
            # the same launch with a residual: its ring of residual tiles fits too
            r = km.plan(m, k, n, out_i8, True)
            assert r.residual and not p.residual
            slots = km.res_slots(k, r.bk)
            assert slots * -(-k // r.bk) >= km.STAGES
            assert r.smem_bytes == km.smem_bytes(64 * r.warpgroups, r.bn, r.bk, out_i8, slots)
            assert r.smem_bytes <= SMEM_BLOCK
            assert r.tiles == -(-m // (64 * r.warpgroups)) * -(-n // r.bn)


def residual_shapes(g):
    """(M, K, N, act) of every conv of `g` that carries a residual once the
    fusion passes have run (``conv_elementwise_fuse``)."""
    PassManager(FUSION_PASSES).run(g)
    out = []
    for op in g.topological_order():
        if op.op_type == "conv2d" and op.maybe_input("ResidualData"):
            n, oh, ow, oc = g.vars[op.output("Output")].shape
            out.append((n * oh * ow, int(np.prod(g.vars[op.input("Filter")].shape[:3])), oc,
                        op.attrs.get("fuse_act")))
    return out


@pytest.mark.parametrize("path,count", [("resnet", 16), ("mobilenet_v3", 10)])
def test_residual_plan_fits_every_residual_shape(path, count):
    """Every residual conv of the path at the card's size: its plan with
    the residual ring fits the block, the ring holds enough tiles for the
    slab ring's lookahead, and the plan without a residual is the one the
    launch had before (the stored-plan table is read only without one)."""
    shapes = residual_shapes(PATHS[path]())
    assert len(shapes) == count
    assert {act for *_, act in shapes} == ({"relu"} if path == "resnet" else {None})
    for m, k, n, _ in shapes:
        for out in (km.OUT_I8, km.OUT_F32):
            r = km.plan(m, k, n, out, True)
            slots = km.res_slots(k, r.bk)
            assert r.residual and slots * -(-k // r.bk) >= km.STAGES
            assert r.smem_bytes == km.smem_bytes(64 * r.warpgroups, r.bn, r.bk, out, slots)
            assert r.smem_bytes <= SMEM_BLOCK
            assert km.plan(m, k, n, out) == km.default_plan(m, k, n, out)
            assert not km.plan(m, k, n, out).residual


@pytest.mark.parametrize("m,k,n,bk,width", [
    (802816, 32, 64, 32, 16),   # K = 32: one slab, nothing past K
    (802816, 16, 16, 32, 16),
    (50176, 72, 40, 32, 8),     # K % 16 = 8: 8-byte copies
    (64, 18, 72, 32, 2),        # the SE fcs: 2-byte copies
    (64, 30, 120, 32, 2),
    (12544, 512, 512, 64, 16),  # 128-byte slabs do not fit at 128 x 256
    (3136, 1024, 1024, 128, 16),
])
def test_plan_slab_and_copy_width(m, k, n, bk, width):
    p = km.plan(m, k, n, True)
    assert (p.bk, p.width) == (bk, width)


@pytest.mark.parametrize("m,n,tiles_at_least", [(64, 1000, 120), (64, 1280, 150),
                                                (3136, 1024, 132), (800, 128, 13)])
def test_plan_spreads_small_m(m, n, tiles_at_least):
    """At small M the tiles narrow until every SM has one (or no narrower
    tile adds one)."""
    p = km.plan(m, 512, n, True)
    assert p.tiles >= tiles_at_least


@pytest.mark.parametrize("m,k,n", [(64, 27, 64), (0, 32, 64), (64, 32, 0), (64, 0, 64)])
def test_plan_refuses_what_the_kernel_cannot_take(m, k, n):
    with pytest.raises(ValueError):
        km.plan(m, k, n, True)


@pytest.mark.parametrize("k,offset,ok", [(64, 0, True), (64, 8, False), (64, 1, False),
                                         (24, 8, True), (24, 4, False), (18, 2, True),
                                         (18, 1, False)])
def test_wrapper_raises_on_misaligned_operands(k, offset, ok):
    p = km.plan(256, k, 64, True)
    buf = torch.zeros(256 * k + 64, dtype=torch.int8)
    base = (-buf.data_ptr()) % 64  # a 64-byte aligned start in the buffer
    x = buf[base + offset: base + offset + 256 * k].view(256, k)
    w_nk = torch.zeros(64, k, dtype=torch.int8)
    if ok:
        km.check_aligned(p, k, x_q=x, w_nk=w_nk)
    else:
        with pytest.raises(ValueError, match="aligned"):
            km.check_aligned(p, k, x_q=x, w_nk=w_nk)


def test_odd_k_is_not_tagged_for_the_kernel():
    from paddle_lite_tpu_torch.core.builder import GraphBuilder

    b = GraphBuilder("odd_k")
    b.fc(b.fc(b.input("x", (4, 27)), 8), 6)
    g = b.build()
    odd, even = (o for o in g.ops if o.op_type == "fc")
    odd.attrs["enable_int8"] = even.attrs["enable_int8"] = True
    assert gemm_eligible(g, even)
    assert not gemm_eligible(g, odd)


# ---- the kernel's epilogue arithmetic, in float32 ----------------------------

_OFFSET = 256 * 128 * 127  # epilogue.cuh's SMALL_OFFSET


def _small_int_to_float(a):
    bits = np.int32(0x4B000000 + _OFFSET) + a.astype(np.int32)
    return bits.view(np.float32) - np.float32(8388608.0 + _OFFSET)


def _requant_lo(y, inv):  # plt::requant_lo's low byte, as an int8
    t = np.fmin(np.fmax(y * inv, np.float32(-127)), np.float32(127))
    return (t + np.float32(12582912.0)).view(np.uint32).astype(np.uint8).view(np.int8)


def _requant(y, inv):  # plt::requant: clip(rint(y * inv), -127, 127)
    q = np.fmin(np.fmax(np.rint(y * inv), np.float32(-127)), np.float32(127))
    return q.astype(np.int8)


def test_small_int_to_float_is_exact_in_its_window():
    a = np.arange(-_OFFSET, (1 << 23) - _OFFSET, dtype=np.int32)
    np.testing.assert_array_equal(_small_int_to_float(a), a.astype(np.float32))
    # K <= 256 keeps every int8 x int8 accumulator inside the window
    assert -256 * 128 * 127 >= -_OFFSET and 256 * 128 * 128 < (1 << 23) - _OFFSET


@pytest.mark.parametrize("inv", [1.0, 0.37, 1e-30, 3e10])
def test_requant_lo_equals_requant(inv):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64).astype(np.uint32)
    y = np.concatenate([
        bits.view(np.float32), np.arange(-300, 300, 0.25, dtype=np.float32),
        np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 127.5, -127.5, 128.5, 126.5,
                  1e-45], np.float32)])
    inv = np.float32(inv)
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(_requant_lo(y, inv), _requant(y, inv))


def test_wgmma_header_is_the_generators_output():
    assert gen_wgmma_s8.HEADER.read_text() == gen_wgmma_s8.render()


# ---- the kernels launch on the current CUDA device only ----------------------

@pytest.mark.parametrize("device,current,ok", [
    (torch.device("cuda", 0), 0, True), (torch.device("cuda", 1), 1, True),
    (torch.device("cuda", 1), 0, False), (torch.device("cuda", 0), 1, False),
    (torch.device("cpu"), 0, False)])
def test_require_current_device(device, current, ok):
    if ok:
        _build.require_current_device(device, "int8_matmul", current=current)
    else:
        with pytest.raises(ValueError, match="current CUDA device"):
            _build.require_current_device(device, "int8_matmul", current=current)


class _FakeLib:
    """Stands in for a built library: counts its per-device set-up and
    reports a layout that names the device it was asked on."""

    def __init__(self):
        self.prepared = []
        self.device = 0

    def plt_dw_conv_prepare(self):
        self.prepared.append(self.device)
        return 0

    def plt_dw_conv_layout(self, k, *outs):
        for i, o in enumerate(outs):
            o._obj.value = 100 * self.device + 10 * k + i
        return 0


def test_prepare_runs_once_per_device(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "_LIBS", {"dw_conv": lib})
    monkeypatch.setattr(_build, "_PREPARED", set())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: lib.device)
    for dev in (0, 0, 1, 1, 0):
        lib.device = dev
        assert _build.load("dw_conv") is lib
    assert lib.prepared == [0, 1]


def test_depthwise_layout_is_per_device(monkeypatch):
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
        a, b = depthwise.layout(3, device=0), depthwise.layout(3, device=1)
        assert a.threads == 30 and b.threads == 130  # asked on its own device
        assert depthwise.layout(3, device=1) is b    # and kept per device
        assert lib.prepared == [0, 1]
    finally:
        depthwise._layout.cache_clear()
