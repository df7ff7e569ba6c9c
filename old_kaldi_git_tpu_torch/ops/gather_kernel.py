"""Batched small-table gather: the decoder's per-arc loglike lookup.

`out[b, j] = table[b, clamp(idx[b, j], 0, P-1)]` for a [B, P] float32 table
and [B, E] int32 indices (reference: lattice-faster-decoder.cc
ProcessEmitting's acoustic cost via DecodableInterface::LogLikelihood).

Replaces the TPU kernel old_kaldi_git_tpu/ops/gather_kernel.py
(`batched_table_gather` → `_pallas_gather` → `_gather_kernel`), a one-hot
compare-and-reduce that exists because the TPU's gather unit is serial.  On
Hopper the kernel is a native gather, csrc/gather.cu: bound by bytes,
4·B·(2E + P); each block stages its batch row's table (8 KB at P = 2000) in
shared memory and gathers from there.  Contract kept from the TPU kernel:
bit-identical to the plain gather, out-of-range indices clamped.

On a CUDA tensor the wrapper launches the kernel or raises.  The plain
version is taken only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch


def batched_table_gather_plain(table: torch.Tensor, idx: torch.Tensor
                               ) -> torch.Tensor:
    """The same function in plain PyTorch (any device)."""
    p = table.shape[1]
    return torch.gather(table, 1, idx.clamp(0, p - 1).long())


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 2 or table.shape[0] != idx.shape[0]:
        raise ValueError(
            f"expected table [B, P] and idx [B, E], got {tuple(table.shape)} "
            f"and {tuple(idx.shape)}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(
            f"expected float32 table and int32 idx, got {table.dtype}, {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device} but idx on {idx.device}")
    if table.shape[1] < 1:
        raise ValueError("empty table row")


def batched_table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, P] float32 table, [B, E] int32 indices → [B, E] float32.

    CUDA tensors go through csrc/gather.cu on the current stream, without
    a synchronise; `batched_table_gather.launches` counts those launches."""
    _check(table, idx)
    if table.device.type == "cpu":
        return batched_table_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise RuntimeError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("batched_table_gather needs contiguous tensors")
    b, p = table.shape
    e = idx.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    from old_kaldi_git_tpu_torch.ops import _build

    fn = _build.bind(
        "gather", "okt_batched_table_gather",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, p, e,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "batched_table_gather")
    batched_table_gather.launches += 1
    return out


batched_table_gather.launches = 0
