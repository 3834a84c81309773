"""Batched squared distances, 1-NN and k-NN winners, and the kNN front end
of the host tools — the counterparts of som_lvq_pak_tpu/ops/distance.py
(all of it), and the reference the winner kernels are held against.

    D[b, n] = ||x_b||^2 - 2 x_b . m_n + ||m_n||^2

With a mask (B, D), nonzero = component masked off (the reference's 'x'
entries, lvq_pak.c:63-72), masked components are zeroed in x and the
||m||^2 term becomes keep @ (M o M)^T, so they are left out of the distance.
A sample with every component masked scores 0 against every code.

Matrix products run in full float32: `fp32_matmul()` turns TF32 off, which
the expanded form needs (it cancels catastrophically for near-winners).

The kNN front end (`chunked_topk`, `pairwise_topk_mode`,
`auto_pairwise_topk`; distance.py:114-227) serves eveninit, balance,
setlabel, elimin and knntest.  Their tie order is the reference's insertion
rule, (distance ascending, index descending).  On a CUDA device with no
mask and k <= 16 (the JAX `use_pallas` rule, distance.py:139-141, and its
Pallas dist_topk's k) each query chunk runs K10 (ops.dist_topk) on the
codebook in reverse row order (reversed once per call), the indices mapped
back as N - 1 - i: K10 takes the lowest index on ties, which is the highest
original one.  Masked
queries and k > 16 take the plain version on the device (`topk_winners`
with reference_ties, chunk by chunk), a route chosen by shape alone and
counted per chunk in `chunked_topk.plain_launches`.  A CPU tensor always
takes the plain version.  The JAX `precision=`, `use_pallas=` and
`chunked_topk(reference_ties=)` arguments have no counterpart: products are
full float32, the device picks the route, and every caller takes the
reference order.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch


def fp32_matmul() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32) on
    CUDA; the plain references are only meaningful at that precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def keep_of(mask: torch.Tensor) -> torch.Tensor:
    """Float32 keep flags of a mask (nonzero = masked): 1 where a
    component takes part, 0 where it is masked."""
    return (mask == 0).to(torch.float32)


def mask_bytes(mask: torch.Tensor) -> torch.Tensor:
    """A mask as the contiguous uint8 array the kernels read (nonzero =
    masked)."""
    return (mask if mask.dtype == torch.uint8 else mask != 0).to(torch.uint8).contiguous()


def sq_distances(x: torch.Tensor, codes: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) squared euclidean distances over unmasked components."""
    fp32_matmul()
    if mask is None:
        x2 = (x * x).sum(-1, keepdim=True)
        c2 = (codes * codes).sum(-1)[None, :]
        return x2 - 2.0 * (x @ codes.T) + c2
    keep = keep_of(mask)
    xk = x * keep
    x2 = (xk * xk).sum(-1, keepdim=True)
    return x2 - 2.0 * (xk @ codes.T) + keep @ (codes * codes).T


def find_winners(x: torch.Tensor, codes: torch.Tensor,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 1-NN: (indices (B,), sq-dists (B,)); ties go to the lowest
    index (torch.argmin returns the first minimum)."""
    d = sq_distances(x, codes, mask)
    idx = torch.argmin(d, dim=-1)
    return idx, d.gather(1, idx[:, None])[:, 0]


def topk_winners(x: torch.Tensor, codes: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None, reference_ties: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched k-NN: (indices (B, k), sq-dists (B, k)) by ascending
    distance.  Equal distances take the lowest index first, as `lax.top_k`
    orders them (the JAX package's reference_ties=False); with
    reference_ties=True the highest index first, the reference insertion
    rule (lvq_pak.c:197-211; distance.py:96-107), by the same picks on the
    distances in reverse column order.  Built from k first-minimum
    `argmin`s, each pick masked out with +inf: `torch.topk` promises no
    order among equal values."""
    if not 1 <= k <= codes.shape[0]:
        raise ValueError(f"k = {k} needs 1 <= k <= {codes.shape[0]} codes")
    d = sq_distances(x, codes, mask)
    work = d.flip(-1) if reference_ties else d.clone()
    idx = torch.empty((x.shape[0], k), dtype=torch.int64, device=x.device)
    for j in range(k):
        idx[:, j] = torch.argmin(work, dim=-1)
        work.scatter_(1, idx[:, j:j + 1], float("inf"))
    if reference_ties:
        idx = codes.shape[0] - 1 - idx
    return idx, d.gather(1, idx)


def k10_route(x: torch.Tensor, codes: torch.Tensor, k: int,
              mask: Optional[torch.Tensor]) -> bool:
    """Whether `chunked_topk` runs K10: a CUDA tensor, no mask, k <= 16."""
    return x.device.type == "cuda" and mask is None and k <= min(16, codes.shape[0])


# K10's route takes query chunks of _K10_CHUNK_ELEMS // N rows by default:
# a sweep is a few launches, and K10's plain version, which the card's
# checks run in its place, forms a (chunk, N) float32 block of 4 GiB at most
_K10_CHUNK_ELEMS = 1 << 30


def chunked_topk(x: torch.Tensor, codes: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None, chunk: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN of x (B, D) in codes (N, D), `chunk` query rows at a time
    (distance.py:114-171): (indices (B, k) int64, sq-dists (B, k)), in
    the reference tie order (the JAX default; nothing asks for the other).
    Each chunk runs K10 where `k10_route` says so (its values clamped at
    0), on the codebook reversed once for all chunks, else the plain
    `topk_winners` (a (chunk, N) block).  By default K10's route takes
    `_K10_CHUNK_ELEMS // N` rows at a time (K10 itself forms no (chunk, N)
    block) and the plain route 4096, the JAX default.  A pair's distance
    does not depend on the chunk, so neither does the result."""
    if not 1 <= k <= codes.shape[0]:
        raise ValueError(f"k = {k} needs 1 <= k <= {codes.shape[0]} codes")
    k10 = k10_route(x, codes, k, mask)
    if chunk is None:
        chunk = max(2, _K10_CHUNK_ELEMS // codes.shape[0]) if k10 else 4096
    if chunk < 2:
        raise ValueError(f"chunk = {chunk}: one-row chunks sum in another order")
    if mask is not None and mask.shape != x.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match x {tuple(x.shape)}")
    if k10:
        from . import dist_topk as k10_mod  # K10's module imports this one
        rev = codes.flip(0)
    bounds = list(range(0, x.shape[0], chunk)) + [x.shape[0]]
    if len(bounds) > 2 and bounds[-1] - bounds[-2] == 1:
        # a one-row product takes BLAS's matrix-vector path, whose sums
        # differ from the matrix path's: the last row joins the chunk before
        del bounds[-2]
    idxs, vals = [], []
    for s, e in zip(bounds[:-1], bounds[1:]):
        xc = x[s:e]
        if k10:
            v, i = k10_mod.dist_topk_reference(xc, rev, k)
            i = i.long()
        else:
            i, v = topk_winners(xc, codes, k, None if mask is None else mask[s:e],
                                reference_ties=True)
            if x.device.type != "cpu":
                chunked_topk.plain_launches += 1
        idxs.append(i)
        vals.append(v)
    if not idxs:
        return (torch.empty((0, k), dtype=torch.int64, device=x.device),
                torch.empty((0, k), dtype=torch.float32, device=x.device))
    return torch.cat(idxs), torch.cat(vals)


chunked_topk.plain_launches = 0

Device = Union[torch.device, str]


def pairwise_topk_mode(X: np.ndarray, codes: np.ndarray, knn: int,
                       xmask: Optional[np.ndarray] = None, mode: str = "fast",
                       device: Device = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Mode-dispatched kNN of the host tools (distance.py:174-187): NumPy
    in, (N, knn) indices and squared distances out.  mode='parity' runs
    ops.exact.pairwise_topk at every size (the C accumulation order, so
    byte-anchored output never depends on the size); mode='fast' (the
    port's default) goes through `auto_pairwise_topk` on `device`."""
    if mode == "fast":
        return auto_pairwise_topk(X, codes, knn, xmask, device=device)
    if mode != "parity":
        raise ValueError(f"unknown mode {mode!r} (parity|fast)")
    from . import exact

    return exact.pairwise_topk(np.asarray(X), np.asarray(codes), knn,
                               None if xmask is None else np.asarray(xmask))


def auto_pairwise_topk(X: np.ndarray, codes: np.ndarray, knn: int,
                       xmask: Optional[np.ndarray] = None, device: Device = "cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Scale-aware kNN front end of the mode='fast' host tools
    (distance.py:190-227): the exact host path (ops.exact.pairwise_topk,
    the C order) up to SOMVQ_AUTO_TOPK_PAIRS query x reference pairs
    (2^25 unless the environment says otherwise; negative: always the
    host), else `chunked_topk` on `device`, whose products sum in another
    order, so near-equal k-th neighbours may order differently there.
    The plain route's query chunks keep its (chunk, N) block near 1 GB,
    as the JAX rule; K10 forms no such block and takes `chunked_topk`'s
    larger default chunk, with the same result as at any chunk."""
    threshold = int(os.environ.get("SOMVQ_AUTO_TOPK_PAIRS", 1 << 25))
    if threshold < 0 or X.shape[0] * codes.shape[0] <= threshold:
        from . import exact

        return exact.pairwise_topk(np.asarray(X), np.asarray(codes), knn,
                                   None if xmask is None else np.asarray(xmask))

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    xt, ct = up(X, np.float32), up(codes, np.float32)
    mt = None if xmask is None else up(xmask, np.uint8)
    chunk = None if k10_route(xt, ct, knn, mt) else \
        max(64, min(4096, (1 << 28) // max(1, codes.shape[0])))
    idx, val = chunked_topk(xt, ct, knn, mt, chunk=chunk)
    return idx.cpu().numpy(), val.cpu().numpy()
