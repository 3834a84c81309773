"""Minibatch SOM training on one device — the counterpart of
som_lvq_pak_tpu/models/trainer.py:SOMTrainer (single device, fused path).

Each step runs one fused kernel (ops.som_step.som_fused_train_step):
batch t's neighbourhood update and batch t+1's winners against the updated
codebook, in one pass over the codebook.  A prologue `dist_argmin` finds
batch 0's winners.  The codebook stays resident on the device and is
updated in place.

Inputs are a Dataset (per-lap shuffled order) or an iterable of chunk
Datasets (e.g. StreamingReader.chunks(laps=None)), with interval
checkpoints in the JAX package's Checkpointer format and resume.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
masked data, `weight=`/`fixed=` tokens, and meshes.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.utils.checkpoint import Checkpointer, TrainState
from som_lvq_pak_tpu.utils.progress import StepTimer

from ..convert import codebook_to_torch, host_tensor, to_dataset
from ..ops.dist_argmin import dist_argmin
from ..ops.som_step import som_fused_train_step
from .common import alpha_schedule, radius_schedule

_MASKED = ("masked data is not ported yet (ROADMAP: trainer masked path, "
           "kernels 1m and 5)")


class SOMTrainer:
    """Minibatch SOM training at device speed on `device` ("cpu" runs the
    kernels' plain versions; "cuda" runs the CUDA kernels)."""

    def __init__(
        self,
        codes: Dataset,
        batch_size: int = 1024,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
        device: Union[torch.device, str] = "cpu",
    ):
        """`seed` fixes the per-lap shuffle of Dataset input."""
        if not codes.is_map:
            raise ValueError("SOMTrainer needs a map codebook")
        if mesh is not None:
            raise NotImplementedError(
                "mesh training is not ported yet (ROADMAP: mesh on "
                "torch.distributed)")
        self.meta = codes
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)
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
        read at each batch's first sample).  A stream that runs dry before
        `rlen` samples raises, unless allow_short_stream=True.  With a
        checkpoint dir and resume=True, continues from the latest step; a
        resumed stream is fast-forwarded to the step's stream position."""
        if use_weights or use_fixed:
            raise NotImplementedError(
                "weight=/fixed= tokens are not ported yet (ROADMAP: trainer "
                "weights/fixed)")
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

        if isinstance(data, Dataset):
            batches = self._dataset_batches(data, start, nb)
        else:
            batches = self._stream_batches(iter(data), start, nb,
                                           allow_short_stream)

        # interval checkpoints fire whenever >= interval batches have
        # elapsed since the last save (not on an exact modulo: the JAX
        # package's grouped path only checks at group boundaries, and a
        # modulo test there silently skipped intervals)
        last_ckpt = start

        def maybe_ckpt(b):
            nonlocal last_ckpt
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) - last_ckpt >= self.checkpoint_interval):
                last_ckpt = b + 1
                self.ckpt.save(TrainState(
                    codes=M.cpu().numpy(), step=b + 1,
                    extra={"alpha": float(alpha), "radius": float(radius)}))

        xdim = meta.xdim
        prev = next(batches, None)
        if prev is not None:
            _, bmu = dist_argmin(prev[1], M)
        while prev is not None:
            b, xb = prev
            nxt = next(batches, None)
            xn = nxt[1] if nxt is not None else xb
            M, bmu, _ = som_fused_train_step(
                M, xb, bmu, xn, xdim, self.hexa, float(talp[b]),
                float(trad[b]), gaussian=self.gaussian)
            if progress is not None:
                progress.step(bs)
            maybe_ckpt(b)
            prev = nxt

        if self.ckpt is not None:
            self.ckpt.save(TrainState(codes=M.cpu().numpy(), step=nb))
            self.ckpt.wait()
        self.meta = replace(to_dataset(M, meta), comments=[])
        return self.meta

    # -- batch sources ---------------------------------------------------

    def _lap_perm(self, lap: int, n: int) -> np.ndarray:
        # resume-safe: lap l's order derives from (seed, lap) alone
        g = torch.Generator().manual_seed(
            ((self.seed & 0xFFFFFFFF) << 32) | (lap & 0xFFFFFFFF))
        return torch.randperm(n, generator=g).numpy()

    def _dataset_batches(self, data: Dataset, start: int, nb: int
                         ) -> Iterator[Tuple[int, torch.Tensor]]:
        """Per-lap shuffled order: lap l is an independent permutation of
        all n samples, batches cut from the concatenated laps (the batch
        analogue of the reference's per-lap shuffle, datafile.c:338-341)."""
        if data.mask is not None:
            raise NotImplementedError(_MASKED)
        X = host_tensor(data.points).to(self.device)
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
            yield b, X[torch.from_numpy(idx).to(self.device)]

    def _stream_batches(self, chunks: Iterator[Dataset], start: int, nb: int,
                        allow_short_stream: bool
                        ) -> Iterator[Tuple[int, torch.Tensor]]:
        """Buffer chunks on the host and ship every whole batch they hold in
        one copy (pinned, asynchronous on CUDA); the remainder waits on the
        host for the next chunk."""
        s = self.batch_size

        def next_chunk():
            try:
                c = next(chunks)
            except StopIteration:
                return None
            if c.mask is not None:
                raise NotImplementedError(_MASKED)
            return (np.ascontiguousarray(c.points, dtype=np.float32), c.n)

        pending = next_chunk()
        # resume-exact streaming: skip start*batch_size samples so batch b
        # trains on the stream positions of the uninterrupted run
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
                bufs.append(pending[0])
                buffered += pending[1]
                pending = next_chunk()
            X = np.concatenate(bufs) if len(bufs) > 1 else bufs[0]
            nfull = min(buffered // s, nb - b) * s
            Xd = host_tensor(X[:nfull])
            if self.device.type == "cuda":
                Xd = Xd.pin_memory().to(self.device, non_blocking=True)
            else:
                Xd = Xd.to(self.device)
            for off in range(0, nfull, s):
                yield b, Xd[off:off + s]
                b += 1
            bufs, buffered = [X[nfull:]], buffered - nfull


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
