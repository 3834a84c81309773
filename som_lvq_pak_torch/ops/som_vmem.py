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

A CUDA tensor launches the persistent cooperative kernel in
`csrc/som_vmem_steps.cu`: the codebook stays in the CTAs' shared memory for
all K steps, with one grid-wide barrier per step, and each step runs K3's
split-TF32 tensor-core arithmetic on it (each 16-row m-tile's work split
over up to four warps), so one launch gives what K chained K3 launches
(`som_fused_train_step(..., factored=False)`) give, bit for bit.  The
K + 1 batches are split into TF32 hi and lo once per launch into a scratch
the wrapper allocates; `k7_rows` picks the codebook rows per CTA.  A grid
that cannot be resident raises; nothing falls back to K3.  A CPU tensor
runs the plain version below: K chained plain K3 steps.  The wrapper
counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .. import _build
from .som_step import feature_passes, som_fused_train_step_plain, split_width


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


def k7_rows(noc: int, D: int, device: torch.device, B: int = 1) -> int:
    """K7's codebook rows per CTA (csrc/som_vmem_steps.cu builds 16, 32, 64
    and 128, 128 not past D 128): the fewest that keep the grid within one
    CTA per SM.  Each 16-row m-tile's work is split over up to four warps,
    and every CTA walks the whole batch every step, so more CTAs than SMs
    only add walks: on an H100 32 rows (128 CTAs) led at 4096 x D 64 and 64
    rows (128 CTAs) at 8192 x D 128 (chip_smoke.py's k7_rows lines;
    PERF.md).  A height whose resident rows (whole rows: past 256 features
    every pass's slab) and step region do not fit in shared memory at B
    samples (the C layout's count, `somvq_vmem_smem_bytes`) is passed over
    for a lower one."""
    props = torch.cuda.get_device_properties(device)
    optin = props.shared_memory_per_block_optin
    smem = _build.library().somvq_vmem_smem_bytes

    def fits(rows):
        return 0 < smem(rows, B, D) <= optin
    for rows in (16, 32, 64):
        if -(-noc // rows) <= props.multi_processor_count and fits(rows):
            return rows
    return next((rows for rows in (64 if D > 128 else 128, 64, 32) if fits(rows)), 16)


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
    # the K batches and the tail split into hi and lo: (K + 1) x 2 planes of
    # (B rounded up to 64, split_width(D)), past 256 features slab by slab
    xs = torch.empty((2 * (K + 1) * -(-B // 64) * 64 * split_width(D),),
                     dtype=torch.float32, device=dev)
    keys = torch.empty((3 * B,), dtype=torch.int64, device=dev)  # 3 key buffers
    bar = torch.zeros((2,), dtype=torch.int32, device=dev)  # grid barrier
    bmu_next = torch.empty((B,), dtype=torch.int32, device=dev)
    _build.call("somvq_som_vmem_steps", codes.data_ptr(), noc, D,
                batches.data_ptr(), K, B, bmu0.data_ptr(), aw.data_ptr(),
                rr.data_ptr(), tail.data_ptr(), int(xdim), int(bool(hexa)),
                int(bool(gaussian)), k7_rows(noc, D, dev, B), xs.data_ptr(),
                keys.data_ptr(), bar.data_ptr(), bmu_next.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    som_vmem_train_steps.launches += 1
    return codes, bmu_next


som_vmem_train_steps.launches = 0
