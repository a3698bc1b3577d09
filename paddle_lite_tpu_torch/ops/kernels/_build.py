"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``.  Libraries go to
``paddle_lite_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
that carries the hash of the sources, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time: the CPU tests
import every module on a machine without ``nvcc``.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so that ``acc*scale`` and
``+bias`` round separately, as in the reference epilogue (and NMS's
``(area_j + area_i) - ix*iy`` likewise), and ``--split-compile=0`` so that
the depthwise kernel's 48 instantiations compile on all cores.  The int8
GEMM is two sources over one kernel (``int8_gemm.cuh``): its dense
instantiations and its gathering conv ones, two libraries built by two
``nvcc`` side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import torch

from ...core import trace

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = {"int8_gemm": "int8_gemm.cu", "int8_gemm_conv": "int8_gemm_conv.cu",
           "dw_conv": "dw_conv.cu", "nms": "nms.cu", "dw_pw_fused": "dw_pw_fused.cu",
           "graph_cond": "graph_cond.cu"}
HEADERS = ("epilogue.cuh", "int8_gemm.cuh", "mma_s8.cuh", "wgmma_s8.cuh")
# per-device set-up a library needs before its first launch on a device
# (shared-memory limits of its kernels), by C function
PREPARE = {"dw_conv": "plt_dw_conv_prepare", "int8_gemm": "plt_int8_gemm_prepare",
           "int8_gemm_conv": "plt_int8_gemm_conv_prepare",
           "dw_pw_fused": "plt_dw_pw_fused_prepare", "nms": "plt_nms_prepare"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
    "--split-compile=0",  # each source's kernels optimized in parallel
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_PREPARED: Set[Tuple[str, int]] = set()  # (library, device index)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: List[str] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: seconds from start to done} for what was
    compiled (``setup.kernels_build``; ``kernels.builds`` counts them)."""
    names = list(SOURCES) if names is None else names
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    with trace.setup_span("setup.kernels_build"):
        secs = _compile(todo)
    trace.count("kernels.builds", len(secs))
    return secs


def _compile(todo: List[str]) -> Dict[str, float]:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        jobs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    secs, errors = {}, []
    for n, (tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{log}")
            continue
        os.replace(tmp, lib_path(n))
        (BUILD_DIR / f"{n}.log").write_text(log)
        secs[n] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_log(name: str) -> str:
    """nvcc / ptxas output of the last build of `name` (registers, spills)."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed, and set up
    (:data:`PREPARE`) for the current CUDA device.  Only a miss is a
    ``setup.kernels_load`` span: the cached lookup runs on every launch."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        with trace.setup_span("setup.kernels_load"):
            lib = ctypes.CDLL(str(lib_path(name)))
            _declare(name, lib)
        _LIBS[name] = lib
    if name in PREPARE:
        key = (name, torch.cuda.current_device())
        if key not in _PREPARED:
            with trace.setup_span("setup.kernels_load"):
                check(getattr(lib, PREPARE[name])(), f"{name} prepare")
            _PREPARED.add(key)
    return lib


def require_current_device(device: torch.device, what: str,
                           current: Optional[int] = None) -> None:
    """Raise ValueError unless `device` is the current CUDA device
    (`current`, by default ``torch.cuda.current_device()``): the kernels
    take raw pointers and launch on the current device and its stream, so a
    tensor on another card must be run under ``torch.cuda.device`` of its
    own."""
    cur = torch.cuda.current_device() if current is None else current
    if device.type != "cuda" or device.index != cur:
        raise ValueError(f"{what}: the tensors are on {device}, but the kernels "
                         f"launch on the current CUDA device, cuda:{cur}; run "
                         f"under torch.cuda.device({device})")


def _declare(name: str, lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    act = [ci, cf, cf, cf]  # a plt::Act code and its three parameters
    if name == "int8_gemm":
        lib.plt_int8_gemm_prepare.argtypes = []
        lib.plt_int8_gemm_prepare.restype = ci
        lib.plt_int8_gemm_occupancy.argtypes = [ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.plt_int8_gemm_occupancy.restype = ci
        fn = lib.plt_int8_gemm
        # ... act, the output kind, inv_out_scale, the residual and its scale, then
        # the plan: bn, bk, warpgroups, width, out_width, shared bytes, blocks
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, *act, ci, cf, vp, cf,
                       ci, ci, ci, ci, ci, ci, ci, vp]
    elif name == "int8_gemm_conv":
        lib.plt_int8_gemm_conv_prepare.argtypes = []
        lib.plt_int8_gemm_conv_prepare.restype = ci
        lib.plt_int8_gemm_conv_occupancy.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.plt_int8_gemm_conv_occupancy.restype = ci
        fn = lib.plt_int8_gemm_conv
        # x, Bt, scale, bias, out, then the conv: n, h, w, c, kh, kw, sh, sw,
        # pt, pb, pl, pr, oc; act, the output kind, inv_out_scale, then the plan
        fn.argtypes = [vp, vp, vp, vp, vp, *[ci] * 13, *act, ci, cf,
                       ci, ci, ci, ci, ci, ci, ci, vp]
    elif name == "dw_conv":
        lib.plt_dw_conv_prepare.argtypes = []
        lib.plt_dw_conv_prepare.restype = ci
        lib.plt_dw_conv_layout.argtypes = [ci] + [ctypes.POINTER(ci)] * 5
        lib.plt_dw_conv_layout.restype = ci
        fn = lib.plt_dw_conv
        # ... act, out_i8, inv_out_scale, then the plan: th, tw, cv, vec,
        # images per block, shared bytes, tiles x, tiles y
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       *act, ci, cf, ci, ci, ci, ci, ci,
                       ctypes.c_longlong, ci, ci, vp]
    elif name == "dw_pw_fused":
        lib.plt_dw_pw_fused_prepare.argtypes = []
        lib.plt_dw_pw_fused_prepare.restype = ci
        lib.plt_dw_pw_fused_layout.argtypes = [ctypes.POINTER(ci)] * 6
        lib.plt_dw_pw_fused_layout.restype = ci
        fn = lib.plt_dw_pw_fused
        # x, dw_w, dw scale, dw bias, dw act, inv_dw, pw_w, pw scale, pw
        # bias, pw act, out_i8, inv_out, out, N, H, W, C, O, then the plan:
        # rows, tw, twp, sub, oc, vec, out_width, shared bytes, tiles, blocks
        fn.argtypes = [vp, vp, vp, vp, *act, cf, vp, vp, vp, *act, ci, cf,
                       vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_longlong, ci, ci, vp]
    elif name == "nms":
        lib.plt_nms_prepare.argtypes = []
        lib.plt_nms_prepare.restype = ci
        lib.plt_nms_layout.argtypes = [ctypes.POINTER(ci)] * 6
        lib.plt_nms_layout.restype = ci
        lib.plt_nms_smem_bytes.argtypes = [ci]
        lib.plt_nms_smem_bytes.restype = ctypes.c_longlong
        fn = lib.plt_nms_keep
        # boxes, scores, out, G, k, iou_t, score_t, iou_div, stream
        fn.argtypes = [vp, vp, vp, ci, ci, cf, cf, ci, vp]
    elif name == "graph_cond":
        ull, sz = ctypes.c_ulonglong, ctypes.c_size_t
        out_vp = ctypes.POINTER(vp)
        # core/conditional_nodes.py: one function a CUDA runtime call
        for fname, args in (("plt_graph_capture_info", [vp, out_vp, out_vp, ctypes.POINTER(sz)]),
                            ("plt_graph_cond_handle", [vp, ctypes.POINTER(ull)]),
                            ("plt_graph_set_cond", [vp, ull, vp]),
                            ("plt_graph_add_cond_node", [vp, vp, sz, ull, ci, out_vp, out_vp]),
                            ("plt_graph_set_deps", [vp, vp]),
                            ("plt_graph_begin_body", [vp, vp]),
                            ("plt_graph_end_body", [vp, vp]),
                            ("plt_graph_stream", [out_vp])):
            getattr(lib, fname).argtypes = args
            getattr(lib, fname).restype = ci
        lib.plt_graph_error.argtypes = [ci]
        lib.plt_graph_error.restype = ctypes.c_char_p
        return
    else:
        raise KeyError(name)
    fn.restype = ctypes.c_int


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
