"""Minibatch SOM and LVQ training on one device — the counterparts of
som_lvq_pak_tpu/models/trainer.py:SOMTrainer, LVQTrainer and OLVQ1Trainer
(single device).  SOMTrainer first; the LVQ trainers are at the end.

Small maps train in groups of GK = 32 batches, one K7 launch per group
(ops.som_vmem.som_vmem_train_steps: the codebook stays on chip for the
whole group), when `use_grouped_steps` says so: the JAX package's
selection predicate, sizes included, so both packages take the grouped
path for the same configurations.  A K1 `dist_argmin` finds the first
group's winners; each group hands the next the winners of its first batch
(`next_first`).  A group with any masked or fixed= batch runs every batch
through the two-kernel step (models.fast.som_batch_step) instead, and the
next clean group finds its winners again.

Otherwise clean batches run one fused kernel per step
(ops.som_step.som_fused_train_step): batch t's neighbourhood update and
batch t+1's winners against the updated codebook, in one pass over the
codebook.  `fused_step_choice` picks the kernel family as the JAX trainer
does (trainer.py:545-583, with its TPU sizes): the separable kernel (K13)
where the grid geometry allows, the batch-chunked one (K14, with a bf16
x-pattern on gaussian maps and bf16 batches where the TPU working set
needs them) at B >= 4096, and the plain kernel (K3) elsewhere.  A
`dist_argmin` prologue finds the first clean batch's winners.  A batch
with masked components runs the two-kernel step (masked `dist_argmin`,
then the masked neighbourhood update), and the next clean batch's winners
are found again against the updated codebook.  A Dataset with a mask runs
the two-kernel step for every batch; a stream decides per batch, on the
host copy of its mask.  The codebook stays resident on the device and is
updated in place.

`bf16=True` keeps that resident codebook in bfloat16 on the single-device
fused path (the kernels read it upcast and blend in float32); it never
takes the grouped path, a masked batch's two-kernel step runs on a float32
copy that is cast back, and a masked Dataset or a mesh trains in float32,
as in the JAX package.  `stream_bf16=True` ships each streamed block to the
device as bfloat16 and upcasts it there (stream input only).  `fit` returns
a float32 codebook either way.

`use_weights` honours `weight=` tokens (per-sample alpha 1 - (1 - a)^w) and
`use_fixed` honours `fixed=` tokens (the sample's winner is its fixed unit),
as som_rout.c:612-632 does.

Inputs are a Dataset (per-lap shuffled order) or an iterable of chunk
Datasets (e.g. StreamingReader.chunks(laps=None)), with interval
checkpoints in the JAX package's checkpoint file format and resume.

With `mesh=` (a parallel.mesh.Mesh; every rank of the world calls `fit` on
the same inputs) the trainers run the sharded steps of parallel.sharded, as
som_lvq_pak_tpu/models/trainer.py:417-444 picks them: a clean float32
Dataset whose map splits into model shards of a multiple of 8 rows takes
the fused pure-TP step (K3 with the shard's unit offset) when the data axis
is 1, else the mixed step (K11, the data-axis sum, K12); streams, masked
Datasets, bf16=True and other shard heights take the two-pass sharded step
(K1, or K4 given a mask).  The trainer runs on the mesh's device; a
`device=` naming another raises ValueError.  The first batch's winners are
found on the whole codebook before it is sliced.  Each rank keeps its
codebook rows; checkpoints gather the whole codebook, and rank 0 writes
them, in the single-device format, so a mesh checkpoint resumes on one
device, on a mesh, or in the JAX package.  `fit` returns the whole codebook
on every rank.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import (codebook_to_torch, labeled_samples_to_torch,
                       lvq_codebook_to_torch, sample_arrays, samples_to_torch,
                       to_dataset)
from ..data.dataset import Dataset, Neighborhood, Topology
from ..ops.dist_argmin import dist_argmin
from ..ops.som_step import factored_geometry_ok, som_fused_train_step
from ..ops.som_vmem import som_vmem_train_steps
from ..parallel import sharded
from ..utils.checkpoint import Checkpointer, TrainState
from ..utils.progress import StepTimer
from .common import alpha_schedule, radius_schedule
from .fast import (effective_alpha, lvq1_batch_step, lvq23_batch_step,
                   olvq1_batch_step, som_batch_step, unit_coords)

# one training batch: (index, x, mask or None, weight or None, fixed or None)
Batch = Tuple[int, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
              Optional[torch.Tensor]]

GK = 32  # batches per group on the grouped path


def use_grouped_steps(noc: int, dim: int, batch_size: int, data,
                      use_fixed: bool = False,
                      vmem_steps: Optional[bool] = None) -> bool:
    """Whether `SOMTrainer.fit` trains in groups of GK batches (one K7
    launch each): the predicate of som_lvq_pak_tpu/models/trainer.py:464-478
    as written, with its TPU sizes (D padded to Dp = 128-multiple, a 4 MB
    codebook, a 14 MB working set), so the same configurations take the
    grouped path in both packages.  Never for a masked Dataset (every batch
    is masked, :370-373), nor with use_fixed on a Dataset that has fixed=
    tokens; vmem_steps=False turns it off."""
    if vmem_steps is False:
        return False
    if isinstance(data, Dataset) and data.mask is not None:
        return False
    dp = -(-dim // 128) * 128
    row_chunk = next((rc for rc in (512, 256, 128, 64, noc)
                      if noc % rc == 0 and rc <= noc), None)
    return (noc * dp * 4 <= (4 << 20)
            and row_chunk is not None
            and (2 * noc * dp * 4 + 2 * batch_size * dp * 4
                 + 3 * row_chunk * batch_size * 4) <= (14 << 20)
            and not (use_fixed and getattr(data, "fixed", None) is not None))


def _fused_step_vmem_bytes(tile_n: int, B: int, D: int, factored: bool = False,
                           dual: bool = False) -> int:
    """A copy of pallas_som.py:fused_step_vmem_bytes (the TPU working set of
    one fused-step grid cell)."""
    common = 2 * B * D * 4 + 3 * tile_n * D * 4
    if factored:
        blocks = (5 if dual else 4) * tile_n * B * 4
    else:
        blocks = 3 * tile_n * B * 4
    return common + blocks


def _pick_fused_tile_n(noc: int, B: int, D: int, xdim: int = 0,
                       factored: bool = False, budget: int = 12 << 20) -> int:
    """A copy of pallas_som.py:pick_fused_tile_n."""
    for tn in (1024, 512, 256, 128, 64, 32, 16, 8):
        if tn > noc:
            continue
        if factored and (xdim <= 0 or tn % xdim != 0):
            continue
        if _fused_step_vmem_bytes(tn, B, D, factored, dual=(tn == xdim)) <= budget:
            return tn
    return 8


def _chunked_step_vmem_bytes(tile_n: int, B: int, BC: int, D: int, xdim: int,
                             hexa: bool, wxa_bf16: bool = False,
                             batch_bf16: bool = False) -> int:
    """A copy of pallas_som.py:chunked_step_vmem_bytes."""
    batch_item = 2 if batch_bf16 else 4
    wxa_item = 2 if wxa_bf16 else 4
    dual = hexa and tile_n == xdim
    pat_rows = 2 * tile_n if dual else tile_n
    return (2 * B * D * batch_item + pat_rows * B * wxa_item
            + 3 * tile_n * D * 4 + 3 * tile_n * BC * 4 + 2 * B * 4)


def fused_step_choice(noc: int, xdim: int, hexa: bool, gaussian: bool,
                      batch_size: int, dim: int
                      ) -> Tuple[bool, int, Optional[int], bool, bool]:
    """(factored, tile_n, batch_chunk, wxa_bf16, batch_bf16) for the fused
    step, as som_lvq_pak_tpu/models/trainer.py:545-583 combines the TPU
    sizing helpers (copied above, D padded to Dp = 128-multiple, a 12 MB
    budget per tile and 14 MB for the batch-chunked step), so both packages
    take the same kernel for the same configuration: the separable kernel
    where its geometry fits a tile; at B >= 4096 (a multiple of 1024) the
    batch-chunked one with 1024-sample chunks where its working set fits,
    with a bf16 x-pattern on gaussian maps and then, if still too large,
    bf16 batches; the plain kernel otherwise."""
    dp = -(-dim // 128) * 128
    tn_fact = _pick_fused_tile_n(noc, batch_size, dp, xdim=xdim, factored=True)
    factored = factored_geometry_ok(noc, xdim, tn_fact, hexa)
    tile_n = tn_fact if factored else _pick_fused_tile_n(noc, batch_size, dp)
    if factored and batch_size >= 4096 and batch_size % 1024 == 0:
        tn_big = _pick_fused_tile_n(noc, 1024, dp, xdim=xdim, factored=True)
        if factored_geometry_ok(noc, xdim, tn_big, hexa):
            for wxa_b, bat_b in ((gaussian, False), (gaussian, True)):
                if _chunked_step_vmem_bytes(tn_big, batch_size, 1024, dp, xdim,
                                            hexa, wxa_b, bat_b) <= (14 << 20):
                    return True, tn_big, 1024, wxa_b, bat_b
    return factored, tile_n, None, False, False


class SOMTrainer:
    """Minibatch SOM training at device speed on `device`: "cuda" (the
    default) runs the CUDA kernels, "cpu" their plain versions.  Without a
    GPU the default raises; it never falls back to the CPU.  With `mesh=`
    the device is the mesh's (module docstring)."""

    def __init__(
        self,
        codes: Dataset,
        batch_size: int = 1024,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
        device: Union[torch.device, str] = "cuda",
        stream_bf16: bool = False,
        vmem_steps: Optional[bool] = None,
        bf16: bool = False,
    ):
        """`seed` fixes the per-lap shuffle of Dataset input.  `vmem_steps`:
        None picks the grouped path when `use_grouped_steps` allows it,
        False never takes it (True acts as None, as in the JAX package).
        `bf16` keeps the fused path's resident codebook in bfloat16;
        `stream_bf16` ships streamed batches as bfloat16 (module
        docstring)."""
        if not codes.is_map:
            raise ValueError("SOMTrainer needs a map codebook")
        self.bf16 = bf16
        self.stream_bf16 = stream_bf16
        self.meta = codes
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.device = _mesh_device(mesh, batch_size, device)
        self.vmem_steps = vmem_steps
        self.gaussian = codes.neigh == Neighborhood.GAUSSIAN
        self.hexa = codes.topol == Topology.HEXA
        self.ckpt = None
        self.checkpoint_interval = checkpoint_interval
        if checkpoint_dir is not None:
            self.ckpt = Checkpointer(checkpoint_dir, background=True)

    def fit(
        self,
        data: Union[Dataset, Iterable[Dataset]],
        rlen: int,
        alpha: float,
        radius: float,
        alpha_type: str = "linear",
        resume: bool = True,
        progress: Optional[StepTimer] = None,
        use_weights: bool = False,
        use_fixed: bool = False,
        allow_short_stream: bool = False,
    ) -> Dataset:
        """Train for `rlen` samples, grouped into batches (the schedules are
        read at each batch's first sample).  `use_weights`/`use_fixed`
        honour the data's `weight=`/`fixed=` tokens (off by default, like
        the C -weights/-fixed flags); masks always apply.  A stream that
        runs dry before `rlen` samples raises, unless
        allow_short_stream=True.  With a checkpoint dir and resume=True,
        continues from the latest step; a resumed stream is fast-forwarded
        to the step's stream position."""
        bs = self.batch_size
        nb = max(1, rlen // bs)
        talp = alpha_schedule(rlen, alpha, alpha_type)[::bs][:nb]
        trad = radius_schedule(rlen, radius)[::bs][:nb]

        M, meta = codebook_to_torch(self.meta, self.device)
        start = 0
        if self.ckpt is not None and resume:
            st = self.ckpt.load()
            if st is not None and st.step < nb:
                # a JAX-written state's prng_key is not needed: Dataset lap
                # orders derive from (seed, lap), streams from the step
                M = torch.tensor(np.asarray(st.codes, np.float32),
                                 device=self.device)
                start = st.step
        # the bf16-resident codebook lives on the single-device fused path
        # only (a masked Dataset runs the two-kernel step on every batch)
        if (self.bf16 and self.mesh is None
                and not (isinstance(data, Dataset) and data.mask is not None)):
            M = M.to(torch.bfloat16)

        xdim = meta.xdim
        extras = dict(xdim=xdim, use_weights=use_weights, use_fixed=use_fixed)
        if isinstance(data, Dataset):
            batches = self._dataset_batches(data, start, nb, **extras)
        else:
            batches = self._stream_batches(iter(data), start, nb,
                                           allow_short_stream, **extras)

        # interval checkpoints fire whenever >= interval batches have
        # elapsed since the last save (not on an exact modulo: the JAX
        # package's grouped path only checks at group boundaries, and a
        # modulo test there silently skipped intervals)
        last_ckpt = start

        def maybe_ckpt(b, full=lambda: M):
            # `full()` gathers a mesh's codebook: every rank takes part
            nonlocal last_ckpt
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) - last_ckpt >= self.checkpoint_interval):
                last_ckpt = b + 1
                _save(self, TrainState(
                    codes=full().float().cpu().numpy(), step=b + 1,
                    extra={"alpha": float(alpha), "radius": float(radius)}))

        if self.mesh is not None:
            M = self._train_mesh(M, data, batches, talp, trad, meta, progress,
                                 maybe_ckpt)
        else:
            train = (self._train_groups
                     if not self.bf16 and use_grouped_steps(
                         *M.shape, bs, data, use_fixed, self.vmem_steps)
                     else self._train_steps)
            train(M, batches, talp, trad, xdim, progress, maybe_ckpt)
        M = M.float()

        if self.ckpt is not None:
            _save(self, TrainState(codes=M.cpu().numpy(), step=nb))
            self.ckpt.wait()
        self.meta = replace(to_dataset(M, meta), comments=[])
        return self.meta

    # -- training loops --------------------------------------------------

    def _train_steps(self, M, batches, talp, trad, xdim, progress, maybe_ckpt):
        """One kernel step per batch: the fused kernel `fused_step_choice`
        picks (K3, K13 or K14) for clean batches, the two-kernel step for
        masked ones.  A bf16 `M` takes the two-kernel step and the winner
        searches of the prologue and re-seeds on a float32 copy (the JAX
        package's `dist_argmin` reads a bf16 codebook upcast)."""
        bs = self.batch_size
        factored, tile_n, chunk, wxa_bf16, batch_bf16 = fused_step_choice(
            M.shape[0], xdim, self.hexa, self.gaussian, bs, M.shape[1])
        choice = dict(factored=factored, tile_n=tile_n, batch_chunk=chunk,
                      wxa_bf16=wxa_bf16, batch_bf16=batch_bf16)
        # bmu: the winners of `prev` when it is a clean batch, found by the
        # previous fused step; None before the first clean batch and after
        # a two-kernel step, whose updated codebook they are found against
        bmu = None
        prev = next(batches, None)
        while prev is not None:
            b, xb, mk, wt, ff = prev
            nxt = next(batches, None)
            if mk is not None:
                M32 = M.float()  # M itself when it is float32
                som_batch_step(M32, xb, xdim, self.hexa, float(talp[b]),
                               float(trad[b]), self.gaussian, mask=mk,
                               weights=wt, fixed_bmu=ff)
                if M32 is not M:
                    M.copy_(M32)
                bmu = None
            else:
                if bmu is None:
                    bmu = _fix(dist_argmin(xb, M.float())[1], ff)
                a = (float(talp[b]) if wt is None else
                     effective_alpha(float(talp[b]), xb.shape[0], M.device, wt))
                _, bmu, _ = som_fused_train_step(
                    M, xb, bmu, xb if nxt is None else nxt[1], xdim,
                    self.hexa, a, float(trad[b]), gaussian=self.gaussian,
                    **choice)
                if nxt is not None:
                    bmu = _fix(bmu, nxt[4])
            if progress is not None:
                progress.step(bs)
            maybe_ckpt(b)
            prev = nxt

    def _train_groups(self, M, batches, talp, trad, xdim, progress, maybe_ckpt):
        """GK batches per K7 launch (som_lvq_pak_tpu/models/trainer.py:
        482-543).  A dirty group (a batch with a mask or fixed= samples;
        streams carry those slices only where the batch has them) runs every
        batch through the two-kernel step, and the next clean group finds
        its winners again with K1; interval checkpoints are taken at group
        boundaries."""
        bs, dev = self.batch_size, M.device
        bmu = None
        group = []
        nxt = next(batches, None)
        while nxt is not None:
            group.append(nxt)
            nxt = next(batches, None)
            if len(group) < GK and nxt is not None:
                continue
            if any(g[2] is not None or g[4] is not None for g in group):
                for b, xb, mk, wt, ff in group:
                    som_batch_step(M, xb, xdim, self.hexa, float(talp[b]),
                                   float(trad[b]), self.gaussian, mask=mk,
                                   weights=wt, fixed_bmu=ff)
                    if progress is not None:
                        progress.step(bs)
                bmu = None
            else:
                if bmu is None:
                    bmu = dist_argmin(group[0][1], M)[1]
                idx = [g[0] for g in group]
                if all(g[3] is None for g in group):
                    alphas = torch.from_numpy(talp[idx]).to(dev)
                else:
                    alphas = torch.stack([
                        effective_alpha(float(talp[b]), bs, dev, wt)
                        for b, _, _, wt, _ in group])
                _, bmu = som_vmem_train_steps(
                    M, torch.stack([g[1] for g in group]), bmu, alphas,
                    torch.from_numpy(trad[idx]).to(dev), xdim, self.hexa,
                    self.gaussian, next_first=None if nxt is None else nxt[1])
                if progress is not None:
                    progress.step(bs * len(group))
            maybe_ckpt(group[-1][0])
            group = []

    def _train_mesh(self, M, data, batches, talp, trad, meta, progress,
                    maybe_ckpt) -> torch.Tensor:
        """The sharded loops (som_lvq_pak_tpu/models/trainer.py:417-444,
        637-706); `M` is the whole starting codebook, the whole trained one
        is returned."""
        mesh, bs = self.mesh, self.batch_size
        n = M.shape[0]
        S, dd = mesh.shape["model"], mesh.shape["data"]
        rows, mine = mesh.rows(n), mesh.batch_rows(bs)
        block = mesh.block(n)
        fused = (isinstance(data, Dataset) and data.mask is None
                 and n % S == 0 and (n // S) % 8 == 0 and not self.bf16)
        if not fused:
            coords = unit_coords(meta.xdim, meta.ydim, self.hexa, M.device)
            Ml = M[rows].clone()
            for b, xb, mk, wt, ff in batches:
                Ml = sharded.sharded_som_step(
                    mesh, Ml, xb[mine], coords[rows], coords, float(talp[b]),
                    float(trad[b]), self.gaussian,
                    mask_local=_cut(mk, mine), weights_local=_cut(wt, mine),
                    fixed_local=_cut(ff, mine), n_local=block)
                if progress is not None:
                    progress.step(bs)
                maybe_ckpt(b, lambda: mesh.gather_rows(Ml, n))
            return mesh.gather_rows(Ml, n)

        # the pipelined fused steps: batch t's winners come from step t-1,
        # the first batch's from the whole codebook before it is sliced
        if dd == 1:
            step = sharded.make_sharded_fused_som_train_step(
                mesh, self.gaussian, meta.xdim, self.hexa).local
            here = slice(None)  # the batch is replicated
        else:
            # two row segments: segment 0's data-axis sum runs under
            # segment 1's accumulation (the same result as one segment)
            step = sharded.make_mixed_fused_som_train_step(
                mesh, self.gaussian, meta.xdim, self.hexa,
                overlap_segments=2).local
            here = mine
        prev = next(batches, None)
        bmu = None
        if prev is not None:
            bmu = _cut(_fix(dist_argmin(prev[1], M)[1], prev[4]), here)
        Ml = M[rows].clone()
        del M
        while prev is not None:
            b, xb, _, wt, _ = prev
            nxt = next(batches, None)
            xn = xb if nxt is None else nxt[1]
            a = (float(talp[b]) if wt is None else
                 effective_alpha(float(talp[b]), bs, xb.device, wt))
            Ml, bmu_next = step(Ml, xb[here], bmu, xn[here], a, float(trad[b]),
                                rows.start)
            if nxt is not None:
                bmu = _fix(bmu_next, _cut(nxt[4], here))
            if progress is not None:
                progress.step(bs)
            maybe_ckpt(b, lambda: mesh.gather_rows(Ml, n))
            prev = nxt
        return mesh.gather_rows(Ml, n)

    # -- batch sources ---------------------------------------------------

    def _lap_perm(self, lap: int, n: int) -> np.ndarray:
        # resume-safe: lap l's order derives from (seed, lap) alone
        return torch.randperm(n, generator=_generator(self.seed, lap)).numpy()

    def _dataset_batches(self, data: Dataset, start: int, nb: int,
                         **extras) -> Iterator[Batch]:
        """Per-lap shuffled order: lap l is an independent permutation of
        all n samples, batches cut from the concatenated laps (the batch
        analogue of the reference's per-lap shuffle, datafile.c:338-341).
        Every batch of a masked Dataset carries its mask slice."""
        arrays = samples_to_torch(data, self.device, **extras)
        n, bs = data.n, self.batch_size
        perm, perm_lap = None, -1
        for b in range(start, nb):
            idx = np.empty((bs,), dtype=np.int64)
            got = 0
            while got < bs:
                lap, off = divmod(b * bs + got, n)
                if lap != perm_lap:
                    perm, perm_lap = self._lap_perm(lap, n), lap
                take = min(bs - got, n - off)
                idx[got:got + take] = perm[off:off + take]
                got += take
            it = torch.from_numpy(idx).to(self.device)
            yield (b, *(None if a is None else a[it] for a in arrays))

    def _stream_batches(self, chunks: Iterator[Dataset], start: int, nb: int,
                        allow_short_stream: bool, **extras
                        ) -> Iterator[Batch]:
        """`_stream_batches` over (points, mask, weight, fixed): a batch
        carries a mask or fixed slice only when its host copy has a masked
        entry or a fixed sample, so a clean batch in a block with masked
        chunks elsewhere takes the fused step (an all-zero mask would send
        it down the masked kernels, whose rounding can flip near-tie
        winners; som_lvq_pak_tpu/models/trainer.py:331-343)."""
        return _stream_batches(chunks, start, nb, self.batch_size, self.device,
                               allow_short_stream, _SOM_ARRAYS,
                               lambda c: sample_arrays(c, **extras),
                               points_bf16=self.stream_bf16)


def _generator(seed: int, k: int) -> torch.Generator:
    """A CPU generator that depends on (seed, k) alone.  The CPU generator
    keeps only the low 32 bits of its seed, so the pair is mixed down to 32
    bits by numpy's SeedSequence rather than packed into one integer."""
    mixed = np.random.SeedSequence([seed & 0xFFFFFFFF, k & 0xFFFFFFFF])
    return torch.Generator().manual_seed(int(mixed.generate_state(1)[0]))


# the arrays of a stream batch: (fill, dtype, rows shaped like the points',
# sparse); a sparse array's batch slice is None where it holds only `fill`
_SOM_ARRAYS = ((0.0, np.float32, False, False),  # points
               (0, np.uint8, True, True),        # mask
               (0.0, np.float32, False, False),  # weight (0 = no token)
               (-1, np.int32, False, True))      # fixed flat unit, -1 = none
_LVQ_ARRAYS = ((0.0, np.float32, False, False),  # points
               (0, np.int32, False, False),      # first label id
               (0, np.uint8, True, True))        # mask


def _stream_batches(chunks: Iterator[Dataset], start: int, nb: int, s: int,
                    device: torch.device, allow_short_stream: bool, specs,
                    unpack, points_bf16: bool = False) -> Iterator[tuple]:
    """Batches (b, *arrays) of `s` samples from a stream of chunk Datasets,
    `unpack(chunk)` giving each chunk's host arrays in `specs` order (None
    where it has none).  Chunks are buffered on the host and every whole
    batch they hold ships in one copy per array (pinned, asynchronous on
    CUDA); the remainder waits on the host for the next chunk.  Resume is
    exact: the first start * s samples are skipped, so batch b trains on
    the stream positions of the uninterrupted run.  With `points_bf16` the
    points (array 0) ship as bfloat16, rounded to nearest even on the host,
    and are upcast to float32 on the device (som_lvq_pak_tpu/models/
    trainer.py:247-252, 326-327, 400-406)."""

    def next_chunk():
        try:
            c = next(chunks)
        except StopIteration:
            return None
        return (*unpack(c), c.n)

    def to_device(a, bf16=False):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if bf16:
            t = t.to(torch.bfloat16)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        return t.float() if bf16 else t

    pending = next_chunk()
    skip = start * s
    while skip > 0 and pending is not None:
        pending, skip = _skip_stream_samples(pending, skip)
        if pending is None:
            pending = next_chunk()
    bufs, buffered, b = [], 0, start
    while b < nb:
        while buffered < s:
            if pending is None:
                if allow_short_stream:
                    return
                raise RuntimeError(
                    f"input stream exhausted at batch {b}/{nb} "
                    f"({buffered} samples buffered, {s} needed): size "
                    "laps to cover rlen, pass laps=None, or set "
                    "allow_short_stream=True")
            bufs.append(pending)
            buffered += pending[-1]
            pending = next_chunk()
        # per array: one host array over the buffered chunks, chunks
        # without it filled with its "absent" value
        ns = [t[-1] for t in bufs]
        host = []
        for k, (fill, dtype, wide, _) in enumerate(specs):
            host.append(_concat([t[k] for t in bufs], ns, fill,
                                host[0].shape[1:] if wide else (), dtype))
        nfull = min(buffered // s, nb - b) * s
        dev = [None if a is None else to_device(a[:nfull], points_bf16 and k == 0)
               for k, a in enumerate(host)]
        for off in range(0, nfull, s):
            sl = slice(off, off + s)
            yield (b, *(None if d is None or (sparse and not (a[sl] != fill).any())
                        else d[sl]
                        for a, d, (fill, _, _, sparse) in zip(host, dev, specs)))
            b += 1
        rest = slice(nfull, None)
        bufs = [tuple(None if a is None else a[rest] for a in host)
                + (buffered - nfull,)]
        buffered -= nfull


def _mesh_device(mesh, batch_size: int, device) -> torch.device:
    """The trainer's device: the mesh's with a mesh (whose data axis must
    split the batch), else `device`.  A `device` that names another device
    than the mesh's raises ValueError ("cuda" names any card), so a mesh on
    the CPU needs device="cpu" here too."""
    want = torch.device(device)
    if mesh is None:
        return want
    if batch_size % mesh.shape["data"]:
        raise ValueError(f"batch_size {batch_size} does not split over the "
                         f"mesh's data axis of {mesh.shape['data']}")
    have = torch.device(mesh.device)
    if want.type != have.type or want.index not in (None, have.index):
        raise ValueError(f"device {want} disagrees with the mesh's device {have}")
    return have


def _save(trainer, state: TrainState) -> None:
    """Write a checkpoint; on a mesh, rank 0 writes for the world."""
    if trainer.mesh is None or trainer.mesh.rank == 0:
        trainer.ckpt.save(state)


def _cut(t: Optional[torch.Tensor], rows: slice) -> Optional[torch.Tensor]:
    return None if t is None else t[rows]


def _fix(bmu: torch.Tensor, fixed: Optional[torch.Tensor]) -> torch.Tensor:
    """Winners with fixed= samples (fixed >= 0) moved to their fixed unit."""
    if fixed is None:
        return bmu
    return torch.where(fixed >= 0, fixed, bmu)


def _concat(parts, counts, fill, row_shape, dtype):
    """One array from per-chunk parts, a chunk's None filled with `fill`;
    None when no chunk has the array."""
    if all(p is None for p in parts):
        return None
    parts = [np.full((n,) + row_shape, fill, dtype) if p is None else p
             for p, n in zip(parts, counts)]
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def _skip_stream_samples(t, skip):
    """Drop the first `skip` samples from a packed chunk tuple
    (*arrays_or_None, n) (trainer.py:_skip_stream_samples).  Returns
    (tuple_or_None, remaining_skip); None = the chunk was consumed
    entirely."""
    n = t[-1]
    if n <= skip:
        return None, skip - n
    if skip == 0:
        return t, 0
    return tuple(a if a is None else a[skip:] for a in t[:-1]) + (n - skip,), 0


# -- LVQ ------------------------------------------------------------------

def _labeled_batches(data: Union[Dataset, Iterable[Dataset]], start: int,
                     nb: int, bs: int, seed: int, device: torch.device,
                     allow_short_stream: bool) -> Iterator[tuple]:
    """(b, x, labels, mask or None) batches for the LVQ trainers (the
    counterpart of som_lvq_pak_tpu/models/trainer.py:_labeled_batches).

    A Dataset is sampled with replacement, batch b's indices drawn from a
    torch.Generator seeded with (seed, b) alone, so resume is exact; every
    batch of a masked Dataset carries its mask slice.  The JAX package
    draws from a threefry key split once per batch, which torch cannot
    reproduce: the two packages draw different batches from one Dataset
    and the same seed.  A stream (an iterable of chunk Datasets) gives the
    same batches in both packages (`_stream_batches`; a batch carries a
    mask only where its host copy has a masked entry)."""
    if not isinstance(data, Dataset):
        yield from _stream_batches(
            iter(data), start, nb, bs, device, allow_short_stream, _LVQ_ARRAYS,
            lambda c: (np.asarray(c.points, np.float32), c.first_labels(), c.mask))
        return
    x, lab, mk = labeled_samples_to_torch(data, device)
    for b in range(start, nb):
        idx = torch.randint(0, data.n, (bs,), generator=_generator(seed, b))
        idx = idx.to(device)
        yield b, x[idx], lab[idx], None if mk is None else mk[idx]


class _LVQBase:
    """What LVQTrainer and OLVQ1Trainer share: a labelled codebook, the
    batch size, the device, the mesh and the checkpointer.  On a mesh each
    rank trains its codebook rows on its batch rows (parallel.sharded); a
    batch with masked components raises ValueError there."""

    def __init__(self, codes: Dataset, batch_size: int, mesh, checkpoint_dir,
                 checkpoint_interval: int, seed: int, device):
        self.meta = codes
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.device = _mesh_device(mesh, batch_size, device)
        self.ckpt = None
        self.checkpoint_interval = checkpoint_interval
        if checkpoint_dir is not None:
            self.ckpt = Checkpointer(checkpoint_dir, background=True)

    def _resume(self, nb: int, resume: bool) -> Optional[TrainState]:
        """The latest checkpoint before step nb (a JAX-written state's
        prng_key is not needed: Dataset batches derive from (seed, b),
        streams from the step)."""
        if self.ckpt is None or not resume:
            return None
        st = self.ckpt.load()
        return st if st is not None and st.step < nb else None

    def _batches(self, data, start, nb, allow_short_stream):
        return _labeled_batches(data, start, nb, self.batch_size, self.seed,
                                self.device, allow_short_stream)

    def _local(self, M: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole codebook `M` (M itself without a
        mesh)."""
        return M if self.mesh is None else M[self.mesh.rows(M.shape[0])].clone()

    def _full(self, M: torch.Tensor) -> torch.Tensor:
        """The whole codebook from this rank's rows (every rank takes part)."""
        return (M if self.mesh is None
                else self.mesh.gather_rows(M, self.meta.n))

    def _mesh_batch(self, xb, xl, mb):
        """This rank's rows of a batch on a mesh; a masked batch raises."""
        if mb is not None and bool((mb != 0).any()):
            raise ValueError(f"{type(self).__name__}(mesh=...): masked batches "
                             "are not supported on the sharded step")
        rows = self.mesh.batch_rows(xb.shape[0])
        return xb[rows], xl[rows]

    def _finish(self, M: torch.Tensor, meta: Dataset, state: TrainState) -> Dataset:
        if self.ckpt is not None:
            _save(self, state)
            self.ckpt.wait()
        self.meta = replace(to_dataset(M, meta), comments=[])
        return self.meta


class LVQTrainer(_LVQBase):
    """Minibatch lvq1 / lvq2.1 / lvq3 training at device speed on `device`:
    "cuda" (the default) runs the CUDA kernels, "cpu" their plain versions;
    without a GPU the default raises.  lvq1 batches take K1 `dist_argmin`
    (K4 when masked), lvq2/lvq3 batches K8 `dist_top2` (K9 when masked);
    models.fast.lvq1_batch_step / lvq23_batch_step; on a mesh
    parallel.sharded.sharded_lvq_step (K1, or K10 `dist_topk` with k = 2,
    per shard).  olvq1 is OLVQ1Trainer.  Interval checkpoints fire whenever
    >= interval batches have elapsed since the last save."""

    def __init__(
        self,
        codes: Dataset,
        algorithm: str = "lvq1",
        batch_size: int = 1024,
        winlen: float = 0.3,
        epsilon: float = 0.1,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
        device: Union[torch.device, str] = "cuda",
    ):
        if algorithm not in ("lvq1", "lvq2", "lvq3"):
            raise ValueError(
                f"unknown algorithm {algorithm!r} (lvq1|lvq2|lvq3; "
                "use OLVQ1Trainer for olvq1)")
        super().__init__(codes, batch_size, mesh, checkpoint_dir,
                         checkpoint_interval, seed, device)
        self.algorithm = algorithm
        self.winlen = float(winlen)
        self.epsilon = float(epsilon)

    def fit(self, data: Union[Dataset, Iterable[Dataset]], rlen: int,
            alpha: float, alpha_type: str = "linear", resume: bool = True,
            progress: Optional[StepTimer] = None,
            allow_short_stream: bool = False) -> Dataset:
        """Train for `rlen` samples in batches; the alpha schedule
        (lvq_pak.c:901-921) is read at each batch's first sample.  A
        stream that runs dry before `rlen` samples raises unless
        allow_short_stream=True."""
        bs = self.batch_size
        nb = max(1, rlen // bs)
        talp = alpha_schedule(rlen, alpha, alpha_type)[::max(1, bs)][:nb]
        M, clabels, meta = lvq_codebook_to_torch(self.meta, self.device)
        start = 0
        st = self._resume(nb, resume)
        if st is not None:
            M = torch.tensor(np.asarray(st.codes, np.float32), device=self.device)
            start = st.step
        if self.mesh is not None:
            sharded.check_lvq_mesh(self.mesh, M.shape[0], self.algorithm)
        n = M.shape[0]
        M = self._local(M)
        last_ckpt = start
        for b, xb, xl, mb in self._batches(data, start, nb, allow_short_stream):
            if self.mesh is not None:
                M = sharded.sharded_lvq_step(
                    self.mesh, M, clabels, *self._mesh_batch(xb, xl, mb),
                    float(talp[b]), self.algorithm, self.winlen, self.epsilon,
                    n_local=self.mesh.block(n))
            elif self.algorithm == "lvq1":
                lvq1_batch_step(M, clabels, xb, xl, float(talp[b]), mask=mb)
            else:
                lvq23_batch_step(M, clabels, xb, xl, float(talp[b]), self.winlen,
                                 epsilon=self.epsilon,
                                 lvq3=self.algorithm == "lvq3", mask=mb)
            if progress is not None:
                progress.step(bs)
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) - last_ckpt >= self.checkpoint_interval):
                last_ckpt = b + 1
                _save(self, TrainState(codes=self._full(M).cpu().numpy(),
                                       step=b + 1))
        M = self._full(M)
        return self._finish(M, meta, TrainState(codes=M.cpu().numpy(), step=nb))


class OLVQ1Trainer(_LVQBase):
    """Minibatch olvq1 training with per-code adaptive learning rates
    (models.fast.olvq1_batch_step: K1 `dist_argmin`, K4 when masked) on
    `device`, "cuda" by default.  `alpha` is the initial rate and the clip.
    Interval checkpoints fire at batches b with (b + 1) % interval == 0
    and carry the alphas."""

    def __init__(
        self,
        codes: Dataset,
        batch_size: int = 1024,
        alpha: float = 0.3,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
        device: Union[torch.device, str] = "cuda",
    ):
        super().__init__(codes, batch_size, mesh, checkpoint_dir,
                         checkpoint_interval, seed, device)
        self.clip = float(alpha)

    def fit(self, data: Union[Dataset, Iterable[Dataset]], rlen: int,
            resume: bool = True, progress: Optional[StepTimer] = None,
            allow_short_stream: bool = False) -> Dataset:
        """`data` is a Dataset (batches sampled with replacement) or an
        iterable of chunk Datasets (StreamingReader.chunks, the reference's
        -buffer reading, lvqtrain.c:181)."""
        nb = max(1, rlen // self.batch_size)
        M, clabels, meta = lvq_codebook_to_torch(self.meta, self.device)
        alphas = torch.full((M.shape[0],), self.clip, dtype=torch.float32,
                            device=self.device)
        start = 0
        st = self._resume(nb, resume)
        if st is not None:
            M = torch.tensor(np.asarray(st.codes, np.float32), device=self.device)
            if st.alphas is not None:
                alphas = torch.tensor(np.asarray(st.alphas, np.float32),
                                      device=self.device)
            start = st.step
        n = M.shape[0]
        M = self._local(M)
        for b, xb, xl, mb in self._batches(data, start, nb, allow_short_stream):
            if self.mesh is not None:
                M, alphas = sharded.sharded_olvq1_step(
                    self.mesh, M, clabels, alphas, *self._mesh_batch(xb, xl, mb),
                    self.clip, n_local=self.mesh.block(n))
            else:
                M, alphas = olvq1_batch_step(M, clabels, alphas, xb, xl,
                                             clip=self.clip, mask=mb)
            if progress is not None:
                progress.step(self.batch_size)
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) % self.checkpoint_interval == 0):
                _save(self, TrainState(codes=self._full(M).cpu().numpy(),
                                       step=b + 1, alphas=alphas.cpu().numpy()))
        M = self._full(M)
        return self._finish(M, meta, TrainState(codes=M.cpu().numpy(), step=nb,
                                                alphas=alphas.cpu().numpy()))
