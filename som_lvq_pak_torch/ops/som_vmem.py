"""K training steps in one launch: kernel K7 (`som_vmem_train_steps`), the
counterpart of som_lvq_pak_tpu/ops/pallas_som.py:som_vmem_train_steps.

    codes, bmu_next = som_vmem_train_steps(codes, batches, bmu0, alphas,
                                           radii, xdim, hexa, gaussian,
                                           next_first=None)

`codes` (noc, D) float32 is updated IN PLACE and returned; `batches` is
(K, B, D) float32, `bmu0` (B,) the winners of batches[0] against `codes`,
`alphas` (K,) or (K, B) the per-step (per-sample) alpha, `radii` (K,) the
per-step radius.  Step t updates the codebook with batch t and its winners,
then finds batch t+1's winners against the updated codebook, exactly as K
chained `som_fused_train_step` calls do.  `bmu_next` (B,) int32 are the
winners of `next_first` (B, D) against the final codebook (the first batch
of the caller's next group, which chains groups exactly), or of batches[-1]
when `next_first` is None.  D is not padded.

A CUDA tensor launches a persistent cooperative kernel, the route
`k7_route` names: up to D 128 `csrc/som_vmem_steps_sm90.cu`, K3's Hopper
walk (csrc/fused_step_sm90.cuh: a producer warp's TMA ring, TF32 `wgmma`)
on each 128-row tile of the codebook, whose split rows stay in the CTA's
shared memory for all K steps, each tile's work split across a
thread-block cluster of c CTAs (each its slab of the features in the
update, its share of the next batch in the winners); past D 128
`csrc/som_vmem_steps.cu`, K3's split-TF32 `mma.sync` body on rows held in
shared memory.  Either way one grid-wide barrier a step, and one launch
gives what K chained K3 launches (`som_fused_train_step(...,
factored=False)`) give, bit for bit.  The batches are split into TF32 hi and
lo once per launch into a scratch the wrapper allocates; `k7_rows` picks the
rows per CTA and the cluster.  A grid that cannot be resident raises;
nothing falls back to K3.  A CPU tensor runs the plain version below: K
chained plain K3 steps.  The wrapper counts its kernel launches in its
`launches` attribute.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import _build
from .som_step import (k3_route, sm90_width, som_fused_train_step_plain,
                        split_width)


def _schedules(alphas, radii, K: int, B: int, dev: torch.device):
    """(alphas (K, B), radii (K,)) as float32 tensors on `dev`."""
    aw = torch.as_tensor(alphas, dtype=torch.float32, device=dev)
    if aw.shape == (K,):
        aw = aw[:, None].expand(K, B)
    if aw.shape != (K, B):
        raise ValueError(f"alphas must be ({K},) or ({K}, {B})")
    rr = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    if rr.shape != (K,):
        raise ValueError(f"radii must be ({K},)")
    return aw, rr


# The walk's 128-row tile, the cluster sizes it builds (each rank's DP / c
# features at least 32, updated in slabs of at most 64) and a forced size
# (None: `k7_rows`'s choice; chip_smoke.py forces each)
K7_TILE = 128
K7_CLUSTERS = (1, 2, 4)
K7_CLUSTER = None


def k7_route(D: int) -> str:
    """K7's kernel for D features, K3's rule (`ops.som_step.k3_route`):
    "sm90", the Hopper walk (csrc/som_vmem_steps_sm90.cu), up to D 128;
    "mma_sync" (csrc/som_vmem_steps.cu) past it.  Both give K chained K3
    steps' floats."""
    return k3_route(D)


def k7_clusters(D: int) -> tuple:
    """The cluster sizes of K7's walk at D (<= 128): each rank's DP / c
    features at least 32 (DP = `sm90_width(D)`)."""
    return tuple(c for c in K7_CLUSTERS if sm90_width(D) // c >= 32)


def k7_cluster(tiles: int, D: int, sms: int) -> int:
    """The CTAs of the cluster that takes each 128-row tile in K7's walk, for
    a codebook of `tiles` tiles on a card of `sms` SMs: the largest size of
    `k7_clusters(D)` whose tiles x size CTAs fill at most one wave of one CTA
    an SM (the grid barrier needs every CTA resident); 1 where the tiles
    alone fill the card.  `k7_rows` then halves it while the card holds
    fewer such clusters at once than there are tiles.  The size moves no
    float: every c gives the K3 chain's codebook and winners."""
    fit = [c for c in k7_clusters(D) if tiles * c <= sms]
    return max(fit) if fit else 1


def k7_walk_smem_bytes(D: int, cluster: int) -> int:
    """The shared memory of K7's walk CTA at D (<= 128) and `cluster` CTAs a
    tile, as csrc/som_vmem_steps_sm90.cu:VmemLayout counts it (a mirror of
    the C layout, `somvq_vmem_smem_bytes`): the 1024-byte alignment, the
    tile's 128 rows split (2 planes of DP floats each), ||m||^2, the ring's
    barriers, and as many ring slots as fit in 232,448 bytes (at most 8),
    each the larger of an update chunk (a slab of F = min(64, DP / c)
    features of 32 samples in 2 planes, then 32 float4 of K3's table) and a
    winner item (2 planes of 64 samples x min(DP, 64) features), rounded up
    to 1024.  It does not depend on B."""
    dp = sm90_width(D)
    f = min(64, dp // cluster)
    upd = 2 * f * 32 * 4 + 32 * 16
    win = 2 * min(dp, 64) * 64 * 4
    slot = -(-max(upd, win) // 1024) * 1024
    fixed = 1024 + 2 * dp * K7_TILE * 4 + K7_TILE * 4 + 2 * 8 * 8
    return fixed + min(8, (232448 - fixed) // slot) * slot


def _k7_resident(D: int, cluster: int) -> int:
    """The clusters of `cluster` CTAs of K7's walk at D resident at once
    (CTAs at cluster 1): cudaOccupancyMaxActiveClusters."""
    out = ctypes.c_int(0)
    _build.call("somvq_vmem_sm90_clusters", D, cluster, ctypes.byref(out))
    return out.value


def k7_rows(noc: int, D: int, device: torch.device, B: int = 1) -> Tuple[int, int]:
    """K7's (codebook rows per CTA, CTAs a tile).  Up to D 128 (the walk):
    (128, c), c `K7_CLUSTER` or `k7_cluster` halved while fewer clusters of
    c fit at once than there are tiles; its shared memory does not depend on
    B.  Past D 128 (csrc/som_vmem_steps.cu builds 16, 32 and 64 rows):
    (rows, 1), the fewest rows that keep the grid within one CTA per SM.
    Each 16-row m-tile's work is split over up to four warps, and every CTA
    walks the whole batch every step, so more CTAs than SMs only add walks
    (chip_smoke.py's k7_rows lines; PERF.md).  A height whose resident rows
    (whole rows: past 256 features every pass's slab) and step region do
    not fit in shared memory at B samples (the C layout's count,
    `somvq_vmem_smem_bytes`) is passed over for a lower one."""
    props = torch.cuda.get_device_properties(device)
    if k7_route(D) == "sm90":
        if K7_CLUSTER is not None:
            return K7_TILE, K7_CLUSTER
        tiles = -(-noc // K7_TILE)
        c = k7_cluster(tiles, D, props.multi_processor_count)
        while c > 1 and _k7_resident(D, c) < tiles:
            c //= 2
        return K7_TILE, c
    optin = props.shared_memory_per_block_optin
    smem = _build.library().somvq_vmem_smem_bytes

    def fits(rows):
        return 0 < smem(rows, 1, B, D) <= optin
    for rows in (16, 32, 64):
        if -(-noc // rows) <= props.multi_processor_count and fits(rows):
            return rows, 1
    return next((rows for rows in (64, 32) if fits(rows)), 16), 1


def chain_steps(step, codes, batches, bmu0, alphas, radii, xdim, hexa,
                gaussian=False, next_first=None):
    """K chained fused steps through `step` (the plain K3, or an emulation
    of its arithmetic with the same arguments): step t updates with batch t
    and its winners, then scores batch t+1 (`next_first`, or the last batch
    if None, after the last step).  Returns (codes, bmu_next)."""
    K, B = batches.shape[:2]
    aw, rr = _schedules(alphas, radii, K, B, codes.device)
    bmu = bmu0
    for t, radius in enumerate(rr.tolist()):
        if t + 1 < K:
            xn = batches[t + 1]
        else:
            xn = batches[-1] if next_first is None else next_first
        codes, bmu, _ = step(codes, batches[t], bmu, xn, xdim, hexa, aw[t], radius,
                             gaussian)
    return codes, bmu


def som_vmem_train_steps_plain(codes, batches, bmu0, alphas, radii, xdim, hexa,
                               gaussian=False, next_first=None):
    """Plain K7: K chained plain K3 steps; same arguments and contract as
    `som_vmem_train_steps`."""
    return chain_steps(som_fused_train_step_plain, codes, batches, bmu0, alphas,
                       radii, xdim, hexa, gaussian, next_first)


def som_vmem_train_steps(
    codes: torch.Tensor,
    batches: torch.Tensor,
    bmu0: torch.Tensor,
    alphas: Union[torch.Tensor, Sequence[float]],
    radii: Union[torch.Tensor, Sequence[float]],
    xdim: int,
    hexa: bool,
    gaussian: bool = False,
    next_first: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run K SOM training steps on `codes` in place; returns (codes,
    bmu_next (B,) int32)."""
    dev = codes.device
    if codes.dim() != 2 or batches.dim() != 3:
        raise ValueError("codes must be (noc, D) and batches (K, B, D)")
    noc, D = codes.shape
    K, B = batches.shape[:2]
    if batches.shape[2] != D or bmu0.shape != (B,):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, batches "
                         f"{tuple(batches.shape)}, bmu0 {tuple(bmu0.shape)}")
    if next_first is not None and next_first.shape != (B, D):
        raise ValueError(f"next_first {tuple(next_first.shape)} must be ({B}, {D})")
    if codes.dtype != torch.float32 or batches.dtype != torch.float32 or (
            next_first is not None and next_first.dtype != torch.float32):
        raise TypeError("codes, batches and next_first must be float32")
    if any(t is not None and t.device != dev for t in (batches, bmu0, next_first)):
        raise ValueError("codes, batches, bmu0 and next_first must share one device")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (updated in place)")
    if K == 0 or B == 0:
        raise ValueError("empty group")
    aw, rr = _schedules(alphas, radii, K, B, dev)
    bmu0 = bmu0.to(torch.int32).contiguous()
    if dev.type == "cpu":
        return som_vmem_train_steps_plain(codes, batches, bmu0, aw, rr, xdim,
                                          hexa, gaussian, next_first)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    batches = batches.contiguous()
    aw = aw.contiguous()
    tail = (batches[-1] if next_first is None else next_first).contiguous()
    Bp = -(-B // 64) * 64
    rows, cluster = k7_rows(noc, D, dev, B)
    walk = k7_route(D) == "sm90"
    # the walk: each batch's transposed planes and the next batches' rows, K x
    # 2 x (DP, Bp) each; past D 128 the K batches and the tail, (K + 1) x 2
    # planes of (Bp, split_width(D)), past 256 features slab by slab
    xs = torch.empty((4 * K * Bp * sm90_width(D) if walk
                      else 2 * (K + 1) * Bp * split_width(D),),
                     dtype=torch.float32, device=dev)
    keys = torch.empty((3 * B,), dtype=torch.int64, device=dev)  # 3 key buffers
    bar = torch.zeros((2,), dtype=torch.int32, device=dev)  # grid barrier
    bmu_next = torch.empty((B,), dtype=torch.int32, device=dev)
    _build.call("somvq_som_vmem_steps_sm90" if walk else "somvq_som_vmem_steps",
                codes.data_ptr(), noc, D, batches.data_ptr(), K, B, bmu0.data_ptr(),
                aw.data_ptr(), rr.data_ptr(), tail.data_ptr(), int(xdim), int(bool(hexa)),
                int(bool(gaussian)), cluster if walk else rows, xs.data_ptr(),
                keys.data_ptr(), bar.data_ptr(), bmu_next.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    som_vmem_train_steps.launches += 1
    return codes, bmu_next


som_vmem_train_steps.launches = 0
