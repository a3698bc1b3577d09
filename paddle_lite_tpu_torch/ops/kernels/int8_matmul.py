"""int8 GEMM with fused scale / bias / activation / requant epilogue.

Port of ``paddle_lite_tpu/ops/kernels/int8_matmul.py`` (``int8_matmul``
``:169``; Pallas kernel ``_matmul_kernel`` ``:43``, epilogue ``_epilogue``
``:31``).  On a CUDA tensor :func:`int8_matmul` launches the hand-written
kernel ``csrc/int8_gemm.cu`` (``wgmma`` s8·s8→s32 from a ring of
``cp.async`` slabs, epilogue in registers, output staged and stored in
whole rows; its header says what bounds it on an H100 and how the design
answers that), with the tiling :func:`plan` picks.  On a CPU tensor it runs
:func:`int8_matmul_plain`, the same function in plain PyTorch.  There is no
fallback from one to the other.

Weights: the kernel reads B transposed, (N, K) with K contiguous.  Callers
that run the same weight many times pass it repacked once as ``w_nk`` (the
reference's ``PrepareForRun`` weight-repack analog, done by the op impl on
its first run); otherwise the wrapper transposes per call.

Requant: the Pallas epilogue multiplies by ``1.0 / out_scale`` computed in
Python double precision and applied as an fp32 constant
(``int8_matmul.py:38``), so the wrapper passes
``float(np.float32(1.0 / out_scale))``, never ``1 / out_scale`` in fp32.

Output kinds (:data:`OUT_F32`, :data:`OUT_I8`, :data:`OUT_I32`): fp32 or
int8 after the epilogue, or (:func:`int8_matmul_i32`) the raw int32
accumulator with no epilogue, the partial product a row-parallel shard
sums over the shards before its epilogue (``parallel/tp_cuda.py``).  The
plans take the kind where they took a bool ``out_i8``; ``True`` /
``False`` still read as int8 / fp32.

Residual: the fp32 and int8 kinds take an optional int8 ``residual`` of
the output's (M, N) shape with one scale ``s_r`` (a shortcut add fused into
a conv, ``ResidualData``): ``y = acc·s (+ bias) + float(r)·s_r`` before the
activation, each step rounded on its own as ``ops/nn._conv_epilogue``
orders it.  Such a launch runs the kernel's residual instantiation, whose
block also holds a ring of residual tiles (:func:`res_slots`), and is
planned by the heuristic alone: the stored plans were measured without
that ring.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import act_params, apply_activation, f32, gelu_approximate
from . import _build, tune_cache

# launches of the CUDA kernel, counted by the wrappers (CPU calls not
# counted): fp32 / int8 out by int8_matmul, int32 out by int8_matmul_i32;
# launches_residual counts those of int8_matmul's that took a residual
launches = 0
launches_i32 = 0
launches_residual = 0

# the activations of every kernel's epilogue (``csrc/epilogue.cuh``,
# ``plt::Act``): those whose fp32 arithmetic the kernels reproduce exactly.
# The depthwise and fused dw+pw kernels compute these only.
ACTS = {None: 0, "": 0, "linear": 0, "relu": 1, "relu6": 2, "leaky_relu": 3,
        "hard_swish": 4, "hard_sigmoid": 5}
# the GEMM's: those, and gelu (code 6 for the tanh form, ACT_GELU_ERF for
# the erf form) and tanh, whose tanhf / erfcf differ from PyTorch's tanh /
# erfc only where the two libraries' functions differ.  sigmoid, swish and
# the other transcendental ones are in no kernel.
GEMM_ACTS = {**ACTS, "gelu": 6, "tanh": 8}
ACT_GELU_ERF = 7


def act_code(act: Optional[str], act_attrs=None, acts=ACTS) -> int:
    """`act`'s ``plt::Act`` code in a kernel whose epilogue computes `acts`
    (:data:`ACTS`, or :data:`GEMM_ACTS` for the GEMM); raises for another."""
    if act not in acts:
        raise NotImplementedError(
            f"activation {act!r} is not in this kernel's epilogue (supported: "
            f"{', '.join(a for a in acts if a)}, none)")
    if act == "gelu" and not gelu_approximate(act_attrs):
        return ACT_GELU_ERF
    return acts[act]


def act_args(act: Optional[str], act_attrs=None, acts=ACTS):
    """(code, p0, p1, p2): the activation as the C entry points take it,
    each parameter rounded once from double to fp32 as the reference
    applies it (gelu's: ``jax.nn.gelu``'s constants)."""
    p = act_params(act, act_attrs) + (0.0, 0.0, 0.0)
    return (act_code(act, act_attrs, acts),) + tuple(float(np.float32(v)) for v in p[:3])


def inv_out_scale(out_scale: float) -> float:
    """1/out_scale rounded once from double to fp32, as the Pallas epilogue
    applies it."""
    return float(np.float32(1.0 / float(out_scale)))


def epilogue(acc: torch.Tensor, eff_scale, bias, act, act_attrs,
             out_scale, residual=None, residual_scale=None) -> torch.Tensor:
    """The kernels' epilogue in plain PyTorch: acc (integer-valued fp32)
    · scale (+ bias) (+ float(residual) · residual_scale) → act → fp32, or
    int8 rint(y · inv) clipped to ±127."""
    y = acc * f32(eff_scale, acc.device)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if residual is not None:
        y = y + residual.to(torch.float32) * f32(residual_scale, acc.device)
    y = apply_activation(y, act, act_attrs)
    if out_scale is None:
        return y
    q = torch.round(y * f32(inv_out_scale(out_scale), acc.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


# The largest K whose int32 accumulator cannot overflow for any int8
# operands: K·128² < 2^31 (K·127² < 2^31, K <= 133,144, for the quantizer's
# ±127 range).  The float64 product is exact far past it (2^53).
I32_MAX_K = (2 ** 31 - 1) // (128 * 128)


def _check_i32_k(k: int) -> None:
    if k > I32_MAX_K:
        raise ValueError(f"int8_matmul_i32: K={k} can overflow the int32 accumulator "
                         f"(|acc| <= K·128² < 2^31 needs K <= {I32_MAX_K})")


def int8_matmul_i32_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain version of the int32 mode: the float64 product cast to int32,
    exact while K·128² < 2^31 (K <= :data:`I32_MAX_K`; K·127² < 2^31,
    K <= 133,144, for operands in the quantizer's ±127); raises past it."""
    _check_i32_k(x_q.shape[1])
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def int8_matmul_plain(x_q, w_q, eff_scale, bias=None, *, act=None,
                      act_attrs=None, out_scale=None, residual=None,
                      residual_scale=None) -> torch.Tensor:
    """Plain PyTorch version: a float64 matmul gives the exact int32
    accumulator, then the identical epilogue as separate torch ops."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.float32)
    return epilogue(acc, eff_scale, bias, act, act_attrs, out_scale, residual,
                    residual_scale)


# ---- the kernel's tiling (csrc/int8_gemm.cu takes these numbers as given) ----

BN_CHOICES = (8, 16, 32, 64, 128, 256)  # tile widths int8_gemm.cu instantiates
OUT_F32, OUT_I8, OUT_I32 = 0, 1, 2  # the kernel's output kinds (OUT_* there)
STAGES = 4            # slabs in the kernel's shared-memory ring (STAGES there)
SMEM_LIMIT = 232448   # shared bytes a block may use on sm_90
SMS = 132             # the H100's SMs: small problems spread over them


class Plan(NamedTuple):
    """One launch's tiling.  A tile is (64·``warpgroups``) × ``bn`` outputs;
    K is walked in ``bk``-byte slabs copied in ``width``-byte pieces; a
    tile's rows are stored in ``out_width``-byte pieces.  A block takes
    ``smem_bytes`` of shared memory; the launch's blocks (:func:`blocks`)
    walk the problem's ``tiles`` tiles between them.  ``residual``: the
    plan of the residual instantiation, whose shared bytes hold the
    residual ring too."""
    bn: int
    bk: int
    warpgroups: int
    width: int
    out_width: int
    smem_bytes: int
    tiles: int
    residual: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def copy_width(k: int) -> int:
    """The widest copy K's rows allow: 16, 8, 4 or 2 bytes (cp.async has 16,
    8 and 4; 2 goes through registers).  An odd K has none."""
    for w in (16, 8, 4, 2):
        if k % w == 0:
            return w
    raise ValueError(f"int8_matmul: K={k} is odd; the kernel copies rows in "
                     f"pieces of 2 bytes or more")


def slab_depths(k: int):
    """BK candidates, best first: 32, 64 or 128 bytes (the kernel's three
    swizzle widths) by the K they pad to (a K <= 128 is one slab, rounded
    up to wgmma's 32-byte depth, where it can be), the deeper first among
    equals."""
    return sorted((32, 64, 128), key=lambda bk: (_cdiv(k, bk) * bk, -bk))


def res_slots(k: int, bk: int) -> int:
    """Residual tiles in a block's ring (``res_slots`` in int8_gemm.cu):
    cdiv(STAGES, slabs a tile), so that a tile's residual, copied with its
    last slab, never lands in a slot an earlier tile's epilogue still
    reads."""
    return _cdiv(STAGES, _cdiv(k, bk))


def smem_bytes(bm: int, bn: int, bk: int, out: int, slots: int = 0) -> int:
    """Shared bytes of a block, as int8_gemm.cu lays them out: the ring of
    STAGES A and Bt slabs, the staged output tile (rows padded by 16 bytes,
    32 for fp32 and int32: an int32 tile takes an fp32 tile's bytes), BN
    scales and BN biases, then `slots` residual tiles of bm rows of bn + 16
    bytes (:func:`res_slots`; 0 without a residual).  `out` is an output
    kind (a bool reads as int8 / fp32)."""
    return (STAGES * (bm + bn) * bk + bm * (bn + 16 if out == OUT_I8 else 4 * bn + 32)
            + 8 * bn + slots * bm * (bn + 16))


def _res_slots(k: int, bk: int, residual: bool) -> int:
    return res_slots(k, bk) if residual else 0


@functools.lru_cache(maxsize=None)
def default_plan(m: int, k: int, n: int, out: int, residual: bool = False) -> Plan:
    """The heuristic tiling of one (M, K) · (K, N) int8 GEMM with output
    kind `out` (:data:`OUT_F32`, :data:`OUT_I8`, :data:`OUT_I32`), with a
    residual or without: pure Python, so the CPU tests check it; the
    kernel checks what it is given and refuses a plan it cannot take.
    Raises ValueError for a problem it cannot take.

    BN is the narrowest tile width that covers N up to 256 (so A is read
    from device memory once), 256 past that; two warpgroups (BM = 128) a
    tile.  Where that leaves fewer tiles than the card has SMs (M ≤ a few
    thousand rows), a wide N takes BN = 128 at BM = 128 if that gives
    every SM a tile; otherwise BM is 64 and BN halves, down to 8, until
    every SM has a tile or halving adds no tile.  BK is the first of
    :func:`slab_depths` whose ring fits the block's shared memory.

    With a residual the epilogue reads a tile's residual too, and the block
    runs its epilogue after its products, so the tile shape follows K (as
    swept on an H100 at the 16 ResNet-50 and 10 MobileNetV3 residual
    shapes): at K <= 256 tiles at most 64 wide on 64-byte slabs (32 at K <=
    32), small enough that two blocks share an SM and one's epilogue
    overlaps the other's copies; past it 128 x 128 tiles on 128-byte
    slabs, where the products dominate and wide tiles read A and B fewer
    times.  Where that does not fit (a wide fp32 tile beside the ring), the
    plan without a residual's, on one warpgroup, then on half the tile
    width, until the ring fits."""
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"int8_matmul: empty problem {(m, k, n)}")
    bn = next((b for b in BN_CHOICES if b >= n), BN_CHOICES[-1])
    if residual:
        rbn, rbk = (min(bn, 64), 32 if k <= 32 else 64) if k <= 256 else (min(bn, 128), 128)
        rwgs = 2 if m > 64 else 1
        if smem_bytes(64 * rwgs, rbn, rbk, out, res_slots(k, rbk)) <= SMEM_LIMIT:
            return plan_of(m, k, n, out, rbn, rbk, rwgs, True)

    def tiles(wgs, bn):
        return _cdiv(m, 64 * wgs) * _cdiv(n, bn)

    wgs = 2 if m > 64 and tiles(2, bn) >= SMS else 1
    if wgs == 1 and n > 256 and tiles(2, 128) >= SMS:  # A is re-read anyway
        wgs, bn = 2, 128
    while tiles(wgs, bn) < SMS and bn > BN_CHOICES[0] and _cdiv(n, bn) < _cdiv(n, bn // 2):
        bn //= 2
    while True:
        bk = next((bk for bk in slab_depths(k) if smem_bytes(
            64 * wgs, bn, bk, out, _res_slots(k, bk, residual)) <= SMEM_LIMIT), None)
        if bk is not None:
            return plan_of(m, k, n, out, bn, bk, wgs, residual)
        wgs, bn = (1, bn) if wgs == 2 else (1, bn // 2)


def plan_of(m: int, k: int, n: int, out: int, bn: int, bk: int, wgs: int,
            residual: bool = False) -> Plan:
    """The plan of one GEMM at tile width `bn`, slab depth `bk` and `wgs`
    warpgroups, with a residual or without (its copy widths, shared bytes
    and tiles follow); raises ValueError for one the kernel cannot run."""
    if bn not in BN_CHOICES or bk not in (32, 64, 128) or wgs not in (1, 2):
        raise ValueError(f"int8_matmul: no instantiation takes bn={bn}, bk={bk}, "
                         f"{wgs} warpgroups")
    if residual and out == OUT_I32:
        raise ValueError("int8_matmul: the int32 output kind takes no residual")
    width = copy_width(k)
    smem = smem_bytes(64 * wgs, bn, bk, out, _res_slots(k, bk, residual))
    if smem > SMEM_LIMIT:
        raise ValueError(f"int8_matmul: bn={bn}, bk={bk}, {wgs} warpgroups take {smem} "
                         f"shared bytes, past the block's {SMEM_LIMIT}")
    tiles = _cdiv(m, 64 * wgs) * _cdiv(n, bn)
    if tiles >= 2 ** 31:
        raise ValueError(f"int8_matmul: {(m, k, n)} has 2^31 tiles or more")
    es = 1 if out == OUT_I8 else 4
    out_width = next(w for w in (16, 8, 4, 2, 1) if (n * es) % w == 0 and (bn * es) % w == 0)
    return Plan(bn, bk, wgs, width, out_width, smem, tiles, residual)


def plan(m: int, k: int, n: int, out: int, residual: bool = False) -> Plan:
    """The tiling of one GEMM: the plan measured fastest for its bucket and
    output kind on the card (``tune_cache.lookup_blocks``, filled by
    ``tune_cache.sweep_gemm_blocks``), else :func:`default_plan`.  A stored
    plan the kernel cannot run raises (:func:`plan_of`).  A launch with a
    residual takes :func:`default_plan`'s: no stored plan was measured with
    the residual ring."""
    if residual:
        return default_plan(m, k, n, out, True)
    stored = tune_cache.lookup_blocks(m, k, n, out)
    if stored is None:
        return default_plan(m, k, n, out)
    return plan_of(m, k, n, out, *stored)


@functools.lru_cache(maxsize=None)
def _resident(device: int, bn: int, wgs: int, out: int, smem: int,
              residual: bool = False) -> int:
    """Blocks of one instantiation the card `device` holds at once, as the
    built library reports its occupancy."""
    import ctypes

    with torch.cuda.device(device):
        per_sm = ctypes.c_int()
        _build.check(_build.load("int8_gemm").plt_int8_gemm_occupancy(
            bn, wgs, int(out), int(residual), smem, ctypes.byref(per_sm)),
            "int8_gemm occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, per_sm.value) * sms


def blocks(p: Plan, out: int, device: int) -> int:
    """The launch's blocks: as many as the card holds at once, at most one
    a tile; each walks its tiles (csrc/int8_gemm.cu)."""
    return min(p.tiles, _resident(device, p.bn, p.warpgroups, int(out), p.smem_bytes,
                                  p.residual))


def check_aligned(p: Plan, k: int, **operands: torch.Tensor) -> None:
    """Raise ValueError unless every operand's data is aligned to the
    plan's copy width (the kernel's copies read ``p.width`` bytes at a
    time); nothing is narrowed silently."""
    for name, t in operands.items():
        if t.data_ptr() % p.width:
            raise ValueError(f"int8_matmul: {name}'s data is not {p.width}-byte "
                             f"aligned, as the plan's copies need for K={k}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"int8_matmul: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def _operands(x_q: torch.Tensor, w_q: torch.Tensor, w_nk: Optional[torch.Tensor],
              what: str):
    """(m, k, n, w_nk) of a launch, each operand checked on the current
    card; w_nk is w_q transposed where the caller passed none."""
    dev = x_q.device
    _build.require_current_device(dev, what)
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} do not compose")
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_nk is None:
        _check(w_q, "w_q", torch.int8, (k, n), dev)
        w_nk = w_q.t().contiguous()
    _check(x_q, "x_q", torch.int8, (m, k), dev)
    _check(w_nk, "w_nk", torch.int8, (n, k), dev)
    return m, k, n, w_nk


def _launch(x_q, w_nk, scale, bias, out, act_c, out_kind: int, inv: float,
            tiling: Optional[Plan], residual: Optional[torch.Tensor] = None,
            residual_scale: float = 0.0) -> torch.Tensor:
    global launches, launches_i32, launches_residual
    m, k = x_q.shape
    n = w_nk.shape[0]
    dev = x_q.device
    p = tiling or plan(m, k, n, out_kind, residual is not None)
    if p.residual != (residual is not None):
        raise ValueError(f"int8_matmul: a plan {'with' if p.residual else 'without'} the "
                         f"residual ring for a launch {'without' if p.residual else 'with'} one")
    check_aligned(p, k, x_q=x_q, w_nk=w_nk)
    lib = _build.load("int8_gemm")
    rc = lib.plt_int8_gemm(
        x_q.data_ptr(), w_nk.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, *act_c, out_kind, inv,
        None if residual is None else residual.data_ptr(), residual_scale,
        p.bn, p.bk, p.warpgroups, p.width, p.out_width, p.smem_bytes,
        blocks(p, out_kind, dev.index), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "int8_gemm")
    if out_kind == OUT_I32:
        launches_i32 += 1
    else:
        launches += 1
        launches_residual += residual is not None
    return out


def int8_matmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    eff_scale,
    bias: Optional[torch.Tensor] = None,
    *,
    act: Optional[str] = None,
    act_attrs: Optional[dict] = None,
    out_scale: Optional[float] = None,
    w_nk: Optional[torch.Tensor] = None,
    tiling: Optional[Plan] = None,
    residual: Optional[torch.Tensor] = None,
    residual_scale: Optional[float] = None,
) -> torch.Tensor:
    """out = epilogue((x_q @ w_q).i32) — fp32 out, or int8 when
    ``out_scale`` is given.  ``x_q`` (M, K) int8, ``w_q`` (K, N) int8,
    ``eff_scale`` = s_x·s_w per output column ((N,) or scalar), ``bias``
    fp32 (N,) or None, ``residual`` a contiguous (M, N) int8 tensor added
    as ``float(r)·residual_scale`` before the activation, or None.
    ``tiling`` is a :func:`plan_of` plan to launch with (a plan sweep's),
    else :func:`plan`'s."""
    if (residual is None) != (residual_scale is None):
        raise ValueError("int8_matmul: a residual takes its scale, and a scale its residual")
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, eff_scale, bias, act=act,
                                 act_attrs=act_attrs, out_scale=out_scale,
                                 residual=residual, residual_scale=residual_scale)
    m, k, n, w_nk = _operands(x_q, w_q, w_nk, "int8_matmul")
    dev = x_q.device
    scale = f32(eff_scale, dev).expand(n).contiguous()
    if bias is not None:
        _check(bias, "bias", torch.float32, (n,), dev)
    if residual is not None:
        _check(residual, "residual", torch.int8, (m, n), dev)
    act_c = act_args(act, act_attrs, GEMM_ACTS)
    out = torch.empty((m, n), device=dev,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    kind = OUT_F32 if out_scale is None else OUT_I8
    inv = 0.0 if out_scale is None else inv_out_scale(out_scale)
    return _launch(x_q, w_nk, scale, bias, out, act_c, kind, inv, tiling, residual,
                   0.0 if residual_scale is None else float(np.float32(residual_scale)))


def int8_matmul_i32(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    *,
    w_nk: Optional[torch.Tensor] = None,
    tiling: Optional[Plan] = None,
) -> torch.Tensor:
    """The raw accumulator ``(x_q @ w_q)`` as an (M, N) int32 tensor: the
    kernel's int32 output kind, no scale, bias, activation or requant.
    Exact while K·128² < 2^31 (K <= :data:`I32_MAX_K`); raises past it.
    On a CPU tensor :func:`int8_matmul_i32_plain`."""
    if x_q.device.type == "cpu":
        return int8_matmul_i32_plain(x_q, w_q)
    m, k, n, w_nk = _operands(x_q, w_q, w_nk, "int8_matmul_i32")
    _check_i32_k(k)
    out = torch.empty((m, n), device=x_q.device, dtype=torch.int32)
    return _launch(x_q, w_nk, None, None, out, act_args(None), OUT_I32, 0.0, tiling)
