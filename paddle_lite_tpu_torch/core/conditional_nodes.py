"""Conditional nodes of a CUDA graph: ``while`` and ``if`` inside one capture.

The reference runs ``while`` as ``jax.lax.while_loop`` and
``conditional_block`` as ``jax.lax.cond`` (``paddle_lite_tpu/ops/
control_flow.py:94, :117``), inside the one XLA computation of a request:
the condition is evaluated on the device and nothing is read back.  The
port's counterpart is a conditional node of the CUDA graph that a request
replays, added while torch captures that graph, through the port's own
library ``csrc/graph_cond.cu`` (built and loaded as the kernels are,
``ops/kernels/_build.py``):

- :func:`while_node` ``(flag, body)``: a WHILE node.  Before it, on the
  capturing stream, a one-thread kernel sets the node's condition from the
  one-byte device tensor `flag`; the node's body is ``body()`` followed by
  the same kernel, so ``body`` must recompute `flag` in place.
- :func:`if_node` ``(pred, then, otherwise)``: an IF node on `pred` whose
  body is ``then()`` and, where `otherwise` is given, a second IF node on
  ``logical_not(pred)`` whose body is ``otherwise()``, as torch's
  ``if_else_node`` builds ``torch.cond``.

A node is made in this order on the stream torch is capturing (the
reference of the order: torch 2.13's ``CUDAGraph::begin_capture_to_if_node``,
which the card's torch does not bind): the graph being captured is read
(``cudaStreamGetCaptureInfo``), a handle is made on it, the condition is
set, the node is added after the capture's dependencies and becomes its
only dependency, and a side stream of this module captures the body into
the node's body graph (``cudaStreamBeginCaptureToGraph``) while it is
torch's current stream.  A body nests: a node made inside a body is added
to that body's graph.  The bodies of one capture allocate from a memory
pool of their own (torch routes a capture's allocations to the graph's pool
only from the capturing stream), which lives as long as the captured graph
(:func:`scope`, ``core/executor.capture_cuda_graph``).

Outside a capture (the CPU; the card's warm-up before a capture) both run
the same body in a host loop on ``bool(flag)``: the same plan, the same
buffers, the condition read on the host.  On the card, under a capture, a
missing runtime call, a failed build or a failed node or body capture
raises, naming what failed; nothing falls back to reading the condition on
the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

IF, WHILE = 0, 1  # the library's node kinds (cudaGraphCondTypeIf / While)

launches = 0  # the set-conditional kernel's launches, each into a capture
nodes = 0  # conditional nodes added

_LOCAL = threading.local()  # .bodies: the _Bodies of this thread's capture
_SIDE: Dict[Tuple[int, int], torch.cuda.Stream] = {}  # (device, depth) -> side stream
_POOLS = weakref.WeakKeyDictionary()  # captured graph -> its bodies' pool


def capturing(device: torch.device) -> bool:
    """Whether the current stream of `device` is capturing a CUDA graph
    (always False on the CPU)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def while_node(flag: torch.Tensor, body: Callable[[], None]) -> None:
    """Run ``body()`` while `flag` (a one-element bool tensor, which `body`
    rewrites in place) holds: under a capture a WHILE node whose body is
    ``body()`` and the kernel that sets the condition from `flag`;
    elsewhere a host loop on ``bool(flag)``."""
    if not capturing(flag.device):
        while bool(flag):
            body()
        return
    _node(WHILE, _flag(flag, "while_node"), body, _bodies())


def if_node(pred: torch.Tensor, then: Callable[[], None],
            otherwise: Optional[Callable[[], None]] = None) -> None:
    """``then()`` where `pred` (a one-element bool tensor) holds, else
    ``otherwise()`` (where given): under a capture an IF node on `pred` and
    one on ``logical_not(pred)``; elsewhere a branch on ``bool(pred)``."""
    if not capturing(pred.device):
        if bool(pred):
            then()
        elif otherwise is not None:
            otherwise()
        return
    pred = _flag(pred, "if_node")
    bodies = _bodies()
    other = None if otherwise is None else torch.logical_not(pred)
    _node(IF, pred, then, bodies)
    if other is not None:
        _node(IF, other, otherwise, bodies)


def set_conditional_plain(flag: torch.Tensor) -> bool:
    """The set-conditional kernel's plain version: the value it gives the
    node, read on the host."""
    return bool(flag)


class _Bodies:
    """The conditional bodies of one capture: the memory pool their
    allocations go to (one for all, nested bodies included), made at the
    first node and kept until the captured graph is destroyed, since every
    replay writes into it."""

    def __init__(self):
        self.device: Optional[int] = None
        self.pool = None
        self.depth = 0  # bodies being captured, one inside another
        self.held = False  # the first routing's reference on the pool is kept

    def enter(self, device: int) -> None:
        if self.depth == 0:
            if self.pool is None:
                self.device, self.pool = device, _torch_call("_graph_pool_handle")()
            _torch_call("_cuda_beginAllocateCurrentThreadToPool")(self.device, self.pool)
        self.depth += 1

    def exit(self) -> None:
        self.depth -= 1
        if self.depth == 0:
            _torch_call("_cuda_endAllocateToPool")(self.device, self.pool)
            if self.held:  # each routing took a reference; the first one stays
                _release(self.device, self.pool)
            self.held = True

    def release(self) -> None:
        if self.held:
            _release(self.device, self.pool)
            self.held = False

    def keep_with(self, graph) -> None:
        """Release the pool when `graph` (the captured graph) is collected."""
        if self.held:
            weakref.finalize(graph, _release, self.device, self.pool).atexit = False
            _POOLS[graph] = self.pool
            self.held = False


def body_pool(graph):
    """The id of the memory pool of `graph`'s conditional bodies, None for a
    graph without conditional nodes."""
    return _POOLS.get(graph)


def _release(device: int, pool) -> None:
    _torch_call("_cuda_releasePool")(device, pool)


@contextlib.contextmanager
def scope() -> Iterator[_Bodies]:
    """Around one capture (``core/executor.capture_cuda_graph``): the
    conditional nodes made inside it put their bodies' allocations in one
    pool of its own; call ``keep_with(graph)`` on what it yields once the
    capture ended.  A capture that fails releases the pool."""
    outer = getattr(_LOCAL, "bodies", None)
    bodies = _LOCAL.bodies = _Bodies()
    try:
        yield bodies
    except BaseException:
        bodies.release()
        raise
    finally:
        _LOCAL.bodies = outer


def _bodies() -> _Bodies:
    bodies = getattr(_LOCAL, "bodies", None)
    if bodies is None:
        raise RuntimeError("a conditional node is made inside a capture that "
                           "core.executor.capture_cuda_graph began (it keeps the "
                           "bodies' memory pool as long as the graph)")
    return bodies


def _torch_call(name: str):
    fn = getattr(torch._C, name, None)
    if fn is None:
        raise RuntimeError(f"conditional nodes: torch {torch.__version__} has no "
                           f"torch._C.{name}, which routes a body's allocations")
    return fn


def _flag(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.bool or t.numel() != 1:
        raise ValueError(f"{what}: the condition is a one-element bool tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    return t


def _library(device: torch.device):
    """The library, built and loaded, for `device`, the current card (the
    nodes' kernel launches there)."""
    from ..ops.kernels import _build

    _build.require_current_device(device, "conditional node")
    return _build.load("graph_cond")


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"conditional node: {what} failed: "
                           f"{lib.plt_graph_error(rc).decode()} ({rc})")


def _current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _side_stream(lib, device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream that captures the bodies at `depth` on `device`: made by
    the library (never one of torch's pooled streams, which another capture
    may be using), once."""
    key = (device.index, depth)
    if key not in _SIDE:
        raw = ctypes.c_void_p()
        _check(lib, lib.plt_graph_stream(ctypes.byref(raw)), "cudaStreamCreateWithFlags")
        _SIDE[key] = torch.cuda.ExternalStream(raw.value, device=device)
    return _SIDE[key]


def _on_stream(stream: torch.cuda.Stream):
    return torch.cuda.stream(stream)


def _capture_info(lib, stream: int):
    graph, deps, n = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    _check(lib, lib.plt_graph_capture_info(stream, ctypes.byref(graph), ctypes.byref(deps),
                                           ctypes.byref(n)), "cudaStreamGetCaptureInfo")
    return graph, deps, n


def _set(lib, stream: int, handle: int, flag: torch.Tensor) -> None:
    """The set-conditional kernel, launched into the capture on `stream`."""
    global launches
    _check(lib, lib.plt_graph_set_cond(stream, handle, flag.data_ptr()),
           "the set-conditional kernel's launch")
    launches += 1


def _node(kind: int, flag: torch.Tensor, body: Callable[[], None], bodies: _Bodies) -> None:
    global nodes
    dev = flag.device
    lib = _library(dev)
    outer = _current_stream(dev)
    graph = _capture_info(lib, outer)[0]
    handle = ctypes.c_ulonglong()
    _check(lib, lib.plt_graph_cond_handle(graph, ctypes.byref(handle)),
           "cudaGraphConditionalHandleCreate")
    _set(lib, outer, handle.value, flag)
    graph, deps, n = _capture_info(lib, outer)
    node, body_graph = ctypes.c_void_p(), ctypes.c_void_p()
    _check(lib, lib.plt_graph_add_cond_node(graph, deps, n, handle.value, kind,
                                            ctypes.byref(node), ctypes.byref(body_graph)),
           "cudaGraphAddNode")
    _check(lib, lib.plt_graph_set_deps(outer, node), "cudaStreamUpdateCaptureDependencies")
    nodes += 1
    side = _side_stream(lib, dev, bodies.depth)
    _check(lib, lib.plt_graph_begin_body(side.cuda_stream, body_graph),
           "cudaStreamBeginCaptureToGraph")
    captured = False
    try:
        bodies.enter(dev.index)
        try:
            with _on_stream(side):
                body()
                if kind == WHILE:
                    _set(lib, side.cuda_stream, handle.value, flag)
        finally:
            bodies.exit()
        captured = True
    finally:
        rc = lib.plt_graph_end_body(side.cuda_stream, body_graph)
        if captured:
            _check(lib, rc, "cudaStreamEndCapture of the body")
