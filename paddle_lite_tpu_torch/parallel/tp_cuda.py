"""Tensor-parallel int8 GEMM: kernel 1 on each shard, collectives between.

Port of ``paddle_lite_tpu/parallel/tp_pallas.py`` (named as
``ops/kernels/ops_cuda.py`` is for ``ops_pallas.py``).  The reference runs
its Pallas GEMM under ``shard_map`` from one process; here each rank calls
these functions with its own shards (SPMD), and the collectives are the
:class:`~.sharding.Mesh`'s.  The two Megatron layouts, composable so a
pair needs one collective:

- **column parallel** (N split): :func:`column_parallel_int8_matmul` runs
  ``csrc/int8_gemm.cu`` with the fused epilogue on the rank's output
  columns (bias, activation and requant are per column, so fully local).
  No collective; the output stays feature-split.
- **row parallel** (K split): :func:`row_parallel_int8_matmul` runs the
  kernel's int32 output kind on the rank's K shard (the raw partial
  accumulator, ``int8_matmul_i32``), sums the partials over the model
  group **in int32** (``all_reduce``, or ``reduce_scatter`` over M with
  ``scatter_batch``), then applies the epilogue
  (``int8_matmul.epilogue``) to the sum cast to fp32, so its roundings are
  those of the single-device kernel.  The reference sums fp32 partials on
  the claim that they stay below 2^24 (``tp_pallas.py:111-116``); |acc|
  <= K·127² passes 2^24 at K = 1,041 a shard, where an odd partial rounds.

:func:`column_shard` / :func:`row_shard` cut the rank's shards and raise
where the model axis does not divide N / K (``tp_pallas.py:69-70``,
``:106-108``).  On CPU tensors the kernels' plain versions run (the
wrappers' rule).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.kernels.int8_matmul import I32_MAX_K, epilogue, int8_matmul, int8_matmul_i32


def column_shard(mesh, w: torch.Tensor, eff_scale, bias: Optional[torch.Tensor] = None,
                 *, axis: str = "model"):
    """The rank's (w[:, n], eff[n], bias[n]) column shard of a (K, N)
    weight, its (N,) or scalar scales and its bias; raises where `axis`
    does not divide N."""
    n, parts = w.shape[1], mesh.parts(axis)
    if n % parts:
        raise ValueError(f"N={n} not divisible by {axis}={parts}")
    eff = torch.as_tensor(eff_scale, dtype=torch.float32, device=w.device).expand(n)
    return (mesh.local_slice(w, axis, 1).contiguous(), mesh.local_slice(eff, axis, 0).contiguous(),
            None if bias is None else mesh.local_slice(bias, axis, 0).contiguous())


def row_shard(mesh, x: torch.Tensor, w: torch.Tensor, *,
              axis: str = "model") -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's (x[:, k], w[k, :]) K shard; raises where `axis` does not
    divide K."""
    k, parts = w.shape[0], mesh.parts(axis)
    if k % parts:
        raise ValueError(f"K={k} not divisible by {axis}={parts}")
    return (mesh.local_slice(x, axis, 1).contiguous(),
            mesh.local_slice(w, axis, 0).contiguous())


def column_parallel_int8_matmul(mesh, x: torch.Tensor, w_shard: torch.Tensor,
                                eff_shard, bias_shard: Optional[torch.Tensor] = None, *,
                                axis: str = "model", act: Optional[str] = None,
                                act_attrs=None, out_scale: Optional[float] = None,
                                w_nk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's (M, N / parts) output columns: kernel 1 with its fused
    epilogue on the (M, K) input and the rank's (K, N / parts) weight
    shard, its scales and bias (:func:`column_shard`).  No collective."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no {axis!r} axis")
    return int8_matmul(x, w_shard, eff_shard, bias_shard, act=act, act_attrs=act_attrs,
                       out_scale=out_scale, w_nk=w_nk)


def row_parallel_int8_matmul(mesh, x_shard: torch.Tensor, w_shard: torch.Tensor,
                             eff_scale, bias: Optional[torch.Tensor] = None, *,
                             axis: str = "model", act: Optional[str] = None,
                             act_attrs=None, out_scale: Optional[float] = None,
                             scatter_batch: bool = False,
                             w_nk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (M, N) product of the K-split operands (:func:`row_shard`): the
    rank's int32 partial (kernel 1's int32 kind), summed over `axis` in
    int32, then the epilogue with the whole `eff_scale` (N,) and `bias`.
    With ``scatter_batch`` the sum is reduce-scattered over M and the rank
    returns its (M / parts, N) rows."""
    k = x_shard.shape[1] * mesh.parts(axis)
    if k > I32_MAX_K:
        raise ValueError(f"row_parallel_int8_matmul: K={k} can overflow the int32 sum "
                         f"(K <= {I32_MAX_K})")
    partial = int8_matmul_i32(x_shard, w_shard, w_nk=w_nk)
    total = (mesh.reduce_scatter(partial, axis) if scatter_batch
             else mesh.all_reduce(partial, axis))
    return epilogue(total.to(torch.float32), eff_scale, bias, act, act_attrs, out_scale)
