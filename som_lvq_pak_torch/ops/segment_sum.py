"""The LVQ steps' segment sum in a fixed order: the counterpart of
`jax.ops.segment_sum` as som_lvq_pak_tpu/models/fast.py and
parallel/sharded.py call it.

    out[n] = sum of rows[b] over the samples b with seg[b] == n

Each segment's rows are added in ascending sample order, starting from 0.0,
and a segment no sample falls in is 0.  That is the order of the CPU's
`index_add_`, `np.add.at` and `jax.ops.segment_sum`, which agree bit for
bit; on CUDA `index_add_` adds with atomics in no fixed order, so the card
gets this order from kernels of its own (csrc/segment_sum.cu): one CTA
sorts the keys (id << 32) | sample (a stable `torch.sort` of the ids past
`SORT_MAX` samples) and marks where each id's run ends, then, into a zeroed
output, one thread per (run, column) walks its run in sample order.  Two
runs on the same inputs are bit-equal, and equal to the CPU's result.
Every LVQ cell of chip_smoke.py steps at B <= 1024, so no cell takes the
`torch.sort` path: it serves callers who pick a batch past `SORT_MAX`, and
chip_smoke.py holds it to np.add.at at B 8192.

This is not a port of a TPU kernel (the JAX package sums in XLA).  A CUDA
tensor launches the kernel, a CPU tensor runs `segment_sum_plain`
(`index_add_`); any other device raises.  The wrapper counts its launches
in its `launches` attribute.
"""

from __future__ import annotations

import torch

from .. import _build

SORT_MAX = 4096  # batches the one-CTA sort of csrc/segment_sum.cu takes


def _check(rows: torch.Tensor, seg: torch.Tensor, noc: int) -> str:
    if rows.dim() < 1 or seg.dim() != 1 or seg.shape[0] != rows.shape[0]:
        raise ValueError(f"rows {tuple(rows.shape)} and seg {tuple(seg.shape)} "
                         "must be (B, ...) and (B,)")
    if rows.dtype != torch.float32:
        raise TypeError("rows must be float32")
    if seg.dtype not in (torch.int32, torch.int64):
        raise TypeError("seg must be int32 or int64")
    if rows.device != seg.device:
        raise ValueError(f"rows on {rows.device}, seg on {seg.device}")
    if noc <= 0:
        raise ValueError(f"noc = {noc} segments")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return rows.device.type


def segment_sum_plain(rows: torch.Tensor, seg: torch.Tensor, noc: int) -> torch.Tensor:
    """(noc, ...) sums of `rows` by segment id: `index_add_` into zeros, which
    on the CPU adds each segment's rows in ascending sample order."""
    out = torch.zeros((noc,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, seg.long(), rows)


def segment_sum(rows: torch.Tensor, seg: torch.Tensor, noc: int) -> torch.Tensor:
    """(noc, ...) float32 sums of `rows` (B, ...) by segment id `seg` (B,),
    each segment's rows added in ascending sample order from 0.0.  The ids
    must lie in [0, noc)."""
    if _check(rows, seg, noc) == "cpu":
        return segment_sum_plain(rows, seg, noc)
    B = rows.shape[0]
    flat = rows.reshape(B, -1).contiguous()
    C = flat.shape[1]
    out = torch.empty((noc,) + rows.shape[1:], dtype=torch.float32,
                      device=rows.device)
    if C == 0:
        return out
    ids = seg.long().contiguous()
    presorted = B > SORT_MAX
    if presorted:  # sorted ids, permutation, run ends
        sorted_ids, order = torch.sort(ids, stable=True)
        scratch = torch.stack([sorted_ids, order, torch.searchsorted(
            sorted_ids, sorted_ids, right=True)]).int()
    else:  # filled by the kernel
        scratch = torch.empty((3, B), dtype=torch.int32, device=rows.device)
    _build.call("somvq_segment_sum", flat.data_ptr(), ids.data_ptr(), B, C, noc,
                int(presorted), scratch.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(rows.device).cuda_stream)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
