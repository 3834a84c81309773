"""The (data, model) mesh on torch.distributed — the counterpart of
som_lvq_pak_tpu/parallel/mesh.py.

The two scaling axes are the JAX package's:
  data  — the batch is sharded across mesh positions (DP);
  model — the codebook rows are sharded across mesh positions (TP); the
          global winner is resolved by gathering (value, global index)
          candidates over the model axis.

JAX runs one controller over a `Mesh` of devices.  The port runs one
process per mesh position (SPMD): every rank calls the same trainer or step
on the same inputs, takes its own slices, and talks to the others only
through collectives on its two axis groups.  Rank r sits at
(data r // S, model r % S) for a model axis of size S, the order of the JAX
mesh's device array.  Rank (d, m) holds batch rows [d B/dd, (d+1) B/dd) and
codebook rows [m ceil(n/S), (m+1) ceil(n/S)) (the last shard may be
shorter).  The JAX collectives map to:

  all_gather over "model"  ->  Mesh.all_gather(t, "model")
  psum over "data"         ->  Mesh.all_reduce(t, "data")
  ppermute around "model"  ->  Mesh.ring_pass(t, "model")

Backend (`initialize_distributed`, `backend_rule`), chosen once from the
caller's device and the cards of this host, never as a fallback:
  device "cpu"             gloo;
  one host (local world == world)
    one card per rank      NCCL, rank r on cuda:r;
    more ranks than cards  gloo, every rank on cuda:0 (NCCL refuses two
                           ranks on one card);
  several hosts            NCCL, each rank on cuda:LOCAL_RANK; a host with
                           more ranks than cards raises (every rank must
                           take the same backend, and a host that took gloo
                           would hang the first collective).
Called with no arguments, `initialize_distributed` starts the world from
torchrun's environment (env://, WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE).  NCCL with one card per rank is the multi-card path
(`chip_smoke.py --mesh` on a host with enough cards); the tests run gloo on
the CPU, and chip_smoke.py's default run gloo on one card.

On several hosts each host reads its own rows (e.g. StreamingReader with
`shard=(host, hosts)`) and its ranks sit on data row `host`:
`Mesh.global_batch` builds the whole batch from each data row's rows, and
the builders take it as they take any batch; their results are whole on
every rank (`Mesh.gather_rows` for a model-sharded one).

`spawn` starts a one-host world through a `file://` rendezvous (no TCP
port), joins it with a time limit, and kills it when the limit passes.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_device: Optional[torch.device] = None  # chosen by initialize_distributed


class Mesh:
    """This rank's place in a (data, model) mesh: `shape` {"data": dd,
    "model": S}, `coords` {"data": d, "model": m}, its `device`, and the
    groups of its two axes (the ranks of its data row for "model", of its
    model column for "data").  Every rank of the world must build it,
    together (group creation is collective)."""

    def __init__(self, data: int, model: int, device, backend: str):
        world, rank = dist.get_world_size(), dist.get_rank()
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} ranks")
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coords = {"data": rank // model, "model": rank % model}
        self.device = torch.device(device)
        self.backend = backend
        self._ranks = {}
        self._groups = {}
        layouts = {"model": [[d * model + m for m in range(model)]
                             for d in range(data)],
                   "data": [[d * model + m for d in range(data)]
                            for m in range(model)]}
        for axis in ("model", "data"):
            for ranks in layouts[axis]:
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    self._ranks[axis], self._groups[axis] = ranks, group

    # -- this rank's slices ---------------------------------------------

    def block(self, n: int) -> int:
        """The height of a model shard of an n-row codebook, ceil(n / S):
        shard m holds the rows from m * block on (the last may be
        shorter)."""
        return -(-n // self.shape["model"])

    def rows(self, n: int) -> slice:
        """This rank's codebook rows of an n-row codebook."""
        block = self.block(n)
        lo = min(n, self.coords["model"] * block)
        return slice(lo, min(n, lo + block))

    def batch_rows(self, b: int) -> slice:
        """This rank's rows of a b-sample batch (b divisible by the data
        axis, as shard_map requires)."""
        dd = self.shape["data"]
        if b % dd:
            raise ValueError(f"batch of {b} does not split over a data axis of {dd}")
        lo = self.coords["data"] * (b // dd)
        return slice(lo, lo + b // dd)

    # -- collectives ------------------------------------------------------

    def _to_backend(self, t: torch.Tensor) -> torch.Tensor:
        """`t` in memory the backend can read and write.  Gloo works on host
        memory: its send/recv read raw host pointers, so with gloo a CUDA
        tensor is staged through a pinned host copy, and its all_gather and
        all_reduce take the same copy, so that every collective has one path.
        Results come back with `.to(device)`.  NCCL and CPU tensors pass as
        they are (a private copy, since collectives write in place)."""
        if self.backend == "gloo" and t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        return t.clone(memory_format=torch.contiguous_format)

    def all_gather(self, t: torch.Tensor, axis: str, async_op: bool = False):
        """(size(axis), *t.shape): `t` of every rank on `axis`, in axis
        order (jax.lax.all_gather).  With async_op the collective is issued
        and a handle returned whose `wait()` gives the stacked tensor; the
        parts are read only after the collective has completed."""
        if self.shape[axis] == 1:
            out = t.unsqueeze(0)
            return _Done(out) if async_op else out
        src = self._to_backend(t)
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        work = dist.all_gather(parts, src, group=self._groups[axis],
                               async_op=async_op)
        if async_op:
            # the handle keeps `src` alive: the collective reads it until wait()
            return _Pending(work, lambda: torch.stack(parts).to(t.device), src)
        return torch.stack(parts).to(t.device)

    def all_reduce(self, t: torch.Tensor, axis: str, async_op: bool = False):
        """The sum of `t` over `axis` (jax.lax.psum).  With async_op the
        collective is issued and a handle returned whose `wait()` gives the
        sum.  With two ranks every element is a + b on both, so the sum of a
        row segment equals that segment of the whole buffer's sum."""
        if self.shape[axis] == 1:
            return _Done(t) if async_op else t
        buf = self._to_backend(t)
        work = dist.all_reduce(buf, group=self._groups[axis], async_op=async_op)
        if async_op:
            return _Pending(work, lambda: buf.to(t.device))
        return buf.to(t.device)

    def ring_pass(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """Send `t` to the previous position of `axis`'s ring and return the
        block of the next one (jax.lax.ppermute with pairs (i, i - 1))."""
        n = self.shape[axis]
        if n == 1:
            return t
        me, ranks = self.coords[axis], self._ranks[axis]
        src = self._to_backend(t)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(me - 1) % n]),
               dist.P2POp(dist.irecv, out, ranks[(me + 1) % n])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device)

    def global_batch(self, local: torch.Tensor) -> torch.Tensor:
        """The whole batch from the rows each data row of the mesh holds
        (jax multihost_utils.host_local_array_to_global_array with
        P("data")): `local` of every position on `data`, concatenated in
        data order.  Every data row must hold as many rows."""
        return self.all_gather(local, "data").reshape((-1,) + tuple(local.shape[1:]))

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The whole (n, ...) codebook from every model shard's rows (shards
        are padded to one height for the gather and trimmed after)."""
        S = self.shape["model"]
        if S == 1:
            return local
        block = self.block(n)
        pad = torch.zeros((block,) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        pad[:local.shape[0]] = local
        return self.all_gather(pad, "model").reshape((S * block,)
                                                     + tuple(local.shape[1:]))[:n]


class _Done:
    def __init__(self, t):
        self._t = t

    def wait(self):
        return self._t


class _Pending:
    def __init__(self, work, result, *keep):
        self._work, self._result, self._keep = work, result, keep

    def wait(self):
        self._work.wait()
        return self._result()


def backend_rule(device_type: str, world: int, local_world: int, local_rank: int,
                 cards: int) -> Tuple[str, Optional[int]]:
    """(backend, this rank's card or None on the CPU) by the rule of the
    module docstring, from the device type, the world's size, the ranks on
    this host and this rank's place among them, and the cards this host
    shows.  A host with more ranks than cards in a world of several hosts
    raises RuntimeError."""
    if device_type == "cpu":
        return "gloo", None
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if local_world == world:  # one host
        return ("nccl", local_rank) if world <= cards else ("gloo", 0)
    if local_world > cards:
        raise RuntimeError(
            f"initialize_distributed: {local_world} ranks on this host of a "
            f"{world}-rank world of several hosts, but {cards} cards; NCCL "
            "needs a card per rank, and every rank must take the same backend")
    return "nccl", local_rank


def _env_int(name: str, value: Optional[int]) -> Optional[int]:
    if value is not None:
        return value
    got = os.environ.get(name)
    return None if got is None else int(got)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, device="cuda",
                           timeout_s: float = 600.0, *,
                           local_rank: Optional[int] = None,
                           local_world_size: Optional[int] = None
                           ) -> Tuple[str, torch.device]:
    """Join a world of `world_size` ranks at `init_method` (e.g.
    "file:///tmp/x", "tcp://host:port" or "env://") with the backend rule
    of the module docstring; returns (backend, this rank's device).

    What is not passed comes from the environment as torchrun sets it: with
    no arguments the world meets at "env://" (MASTER_ADDR, MASTER_PORT),
    `world_size` is WORLD_SIZE, `rank` RANK, `local_rank` LOCAL_RANK and
    `local_world_size` LOCAL_WORLD_SIZE.  Where neither local number is
    known the world is one host (local rank = rank, local world = world).
    A CUDA device without a GPU raises.  Already initialized: the world is
    kept and its size and rank are read from it."""
    global _device
    dev = torch.device(device)
    if dist.is_initialized():
        world_size = dist.get_world_size() if world_size is None else world_size
        rank = dist.get_rank() if rank is None else rank
    world_size, rank = _env_int("WORLD_SIZE", world_size), _env_int("RANK", rank)
    if world_size is None or rank is None:
        raise RuntimeError("initialize_distributed: world_size and rank not given "
                           "and WORLD_SIZE/RANK not set (as torchrun sets them)")
    local_rank = _env_int("LOCAL_RANK", local_rank)
    local_world_size = _env_int("LOCAL_WORLD_SIZE", local_world_size)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: device 'cuda' but no GPU")
    backend, card = backend_rule(
        dev.type, world_size, world_size if local_world_size is None else local_world_size,
        rank if local_rank is None else local_rank,
        torch.cuda.device_count() if dev.type == "cuda" else 0)
    if card is not None:
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    _device = dev
    return dist.get_backend(), dev


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None, device=None) -> Mesh:
    """The (data, model) mesh over the whole world (one rank per position),
    factored as the JAX package's make_mesh does when only the size is
    given.  `device` defaults to the one `initialize_distributed` chose, or
    for a world started without it (torchrun and init_process_group) to the
    card by the backend rule: cuda:LOCAL_RANK under NCCL, cuda:0 under gloo.
    Without a GPU that default raises: the mesh is on the CPU only when the
    caller passes device="cpu"."""
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh spans the world: {n_devices} != {world} ranks")
    if data is None and model is None:
        data, model = _factor(n_devices)
    elif data is None:
        data = n_devices // model
    elif model is None:
        model = n_devices // data
    if data * model != n_devices:
        raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
    if device is None:
        device = _device if _device is not None else _default_card()
    return Mesh(data, model, device, dist.get_backend())


def _default_card() -> torch.device:
    """The card of this rank in a world that `initialize_distributed` did
    not start, by the backend the world took: cuda:LOCAL_RANK under NCCL
    (rank modulo the cards where LOCAL_RANK is not set), cuda:0 under
    gloo."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no device given and no GPU; pass "
                           "device='cpu' for a mesh on the CPU")
    if dist.get_backend() == "nccl":
        local = os.environ.get("LOCAL_RANK")
        return torch.device("cuda", int(local) if local is not None
                            else dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", 0)


def class_blocked_order(labels) -> np.ndarray:
    """Permutation putting same-class codebook rows in contiguous blocks
    — the expert-parallel analogue (SURVEY.md §2.6): with the codebook
    sharded by rows over the model axis, a class-blocked layout lands
    each class's codes on as few shards as possible, so per-class
    workloads (LVQ updates, class statistics) touch fewer shards and the
    balance/eveninit quota logic stays shard-local.

    Returns indices such that codes.take(order) is class-blocked; a
    stable sort keeps the within-class (file) order the quota rules
    depend on."""
    labels = np.asarray(labels)
    return np.argsort(labels, kind="stable")


def _factor(n: int) -> Tuple[int, int]:
    """(data, model) with model the larger power-of-2-ish factor."""
    data = 1
    model = n
    # prefer a 2-way or 4-way data axis when it divides evenly
    for d in (4, 2):
        if n % d == 0 and n // d >= d:
            data, model = d, n // d
            break
    return data, model


# -- one-host worlds ----------------------------------------------------------

def spawn(fn, data: int, model: int, device, *args, timeout_s: float = 300.0):
    """Run `fn(mesh, *args)` in a new world of data x model processes on
    `device` ("cpu", or "cuda": ranks share the card(s) by the backend
    rule); returns each rank's result, tensors as NumPy arrays.  `fn` must
    be a module-level function of an importable module (children are
    started with the "spawn" method and import only what `fn` needs).  The
    world meets at a `file://` rendezvous in a fresh temporary directory.
    A rank that raises or exits non-zero, or a world still running after
    `timeout_s`, kills every rank and raises."""
    world = data * model
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="somvq_mesh_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, data, model, str(device), init,
                               timeout_s, args, results))
             for rank in range(world)]
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: the {data}x{model} world passed its "
                                   f"limit of {timeout_s} s ({len(got)} ranks done)")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: ranks exited without a result "
                                       f"(rank, exit code): {dead}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawn: ranks exited non-zero (rank, code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]


def _child(fn, rank, data, model, device, init, timeout_s, args, results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)  # many ranks share the host's cores
        initialize_distributed(init, data * model, rank, device, timeout_s,
                               local_rank=rank, local_world_size=data * model)
        out = fn(make_mesh(data * model, data, model), *args)
        results.put((rank, True, _to_host(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _to_device(obj, device):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


def call_each(mesh: Mesh, calls):
    """A `spawn` worker: for each call (target, args, kwargs, then), with
    target "module:name", build obj = name(*args, mesh=mesh, **kwargs); then
    is None (the result is obj), one (method, a, kw) or a list of them, run
    in turn on obj: obj(*a, **kw) for method None, else
    obj.method(*a, **kw); the result is the last one's.  NumPy arrays in the
    arguments arrive as tensors on the rank's device.  Returns the list of
    results."""
    out = []
    for target, args, kwargs, then in calls:
        module, name = target.split(":")
        obj = res = getattr(importlib.import_module(module), name)(
            *_to_device(args, mesh.device), mesh=mesh,
            **_to_device(kwargs, mesh.device))
        for method, a, kw in ([] if then is None
                              else [then] if isinstance(then, tuple) else then):
            fn = obj if method is None else getattr(obj, method)
            res = fn(*_to_device(a, mesh.device), **_to_device(kw, mesh.device))
        out.append(res)
    return out
