"""LVQ: trainers (lvq1/olvq1/lvq2.1/lvq3), initializers (eveninit/propinit,
pick, balance) and class statistics (min/median distances, deviations) —
the counterpart of som_lvq_pak_tpu/models/lvq.py (all of it).

Reference behaviour: lvq_rout.c (trainers :498-916, picking :85-239, class
stats :280-492,929-1004), eveninit.c:46-158, balance.c:44-226.  Two paths,
as in the JAX package:

* parity — host NumPy with the C package's float32 op order (the port's
  ops.exact): `knn_correct_mask`, `pick_inside_codes`, `pick_codes`,
  `eveninit` (lvq.py:34-152), `class_nearest_stats`, `deviations`,
  `balance` (:159-320) and the parity and streamed loops of the trainers
  (:327-621) are copies, held bit-equal to the JAX package's by tests.
  They need no device.
* fast — the device, "cuda" unless the caller asks for "cpu" (the plain
  versions of the kernels).  The kNN sweeps go through
  ops.distance.chunked_topk (K10 on the reversed codebook); the trainers
  are the JAX package's scans (lvq.py:628-747), one sample per step:
  lvq1 and olvq1 take their winner from `dist_argmin` (K1 at B 1; K4 under
  a mask), lvq2.1/lvq3 their winner pair from `dist_top2` (K8; K9 under a
  mask), with the scans' float32 expressions.  The order, schedule and
  labels are uploaded once, a block of steps gathered by one index_select,
  and no step fetches anything to the host.  A sample with every
  component masked scores 0 against every code, so its winner is code 0
  (K4's and K9's rule, as the JAX argmin's): its update is all masked, but
  olvq1 still moves alpha[0], as the JAX scan does.

The port's entry points default to the fast path (`mode="fast"`,
`device="cuda"`); the JAX package's to parity.  `balance` is parity only,
as in the JAX package: it passes mode="parity" to its kNN sweep and its
olvq1 pass, which the JAX package reaches through its defaults.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.dataset import Dataset, Topology
from ..ops import exact
from ..ops.dist_argmin import dist_argmin
from ..ops.dist_top2 import dist_top2
from ..ops.distance import chunked_topk
from ..utils.hitlist import Hitlist, majority_label_matrix
from ..utils.rng import CRandom
from .common import ALPHA_LINEAR, alpha_schedule, sample_order, scan_blocks
from .som import _is_stream

F32 = np.float32

Device = Union[torch.device, str]


# ---------------------------------------------------------------------------
# kNN correctness (the eveninit/balance work-horse)
# ---------------------------------------------------------------------------

def knn_correct_mask(data: Dataset, knn: int, mode: str = "fast",
                     device: Device = "cuda") -> np.ndarray:
    """(N,) bool: is entry i correctly classified by kNN majority vote
    against the *whole* data set (itself included, at distance 0)?

    Replaces the reference's per-pick rescan correct_by_knn
    (lvq_rout.c:38-80) with one batched all-pairs computation.  Tie
    semantics preserved: neighbor order is (distance asc, index desc)
    (find_winner_knn insertion rule) and the majority vote follows the
    hitlist head rule (labels.c:278-443).  mode='fast': chunked_topk on
    `device`; mode='parity': the exact host path at every size."""
    if knn < 1:
        knn = 1
    if mode == "fast":
        dev = torch.device(device)
        pts = torch.from_numpy(np.ascontiguousarray(data.points, F32)).to(dev)
        mask = None if data.mask is None else torch.from_numpy(
            np.ascontiguousarray(data.mask)).to(dev)
        idx = chunked_topk(pts, pts, knn, mask)[0].cpu().numpy()
    elif mode == "parity":
        # the exact host path UNCONDITIONALLY (C accumulation order at every
        # size): byte-for-byte eveninit/balance output must not depend on
        # the data size
        idx, _ = exact.pairwise_topk(
            np.asarray(data.points), np.asarray(data.points), knn,
            None if data.mask is None else np.asarray(data.mask))
    else:
        raise ValueError(f"unknown mode {mode!r} (parity|fast)")
    labels = data.first_labels()
    neigh_labels = labels[idx]  # (N, knn)
    num = int(labels.max()) + 1
    win = majority_label_matrix(neigh_labels, num)
    return win == labels


def pick_inside_codes(
    quotas: Hitlist, data: Dataset, knn: int, correct: Optional[np.ndarray] = None,
    mode: str = "fast", device: Device = "cuda",
) -> List[int]:
    """Walk the data in order picking per-class quotas of vectors that
    are kNN-correct against the full set (lvq_rout.c:151-211).
    Returns the picked row indices in pick order.  Mutates `quotas`.
    Without `correct`, `knn_correct_mask(data, knn, mode, device)`."""
    if correct is None:
        correct = knn_correct_mask(data, knn, mode=mode, device=device)
    labels = data.first_labels()
    total = sum(freq for _, freq in quotas.items())
    picked: List[int] = []
    for i in range(data.n):
        if total == 0:
            break
        cls = quotas.find_hit(int(labels[i]))
        if cls is not None and cls[1] > 0 and correct[i]:
            picked.append(i)
            cls[1] -= 1
            total -= 1
    return picked


def pick_codes(num: int, data: Dataset) -> Dataset:
    """First `num` entries as a codebook (pick_codes, lvq_rout.c:85-119;
    the `pick` tool).  Keeps the source header's topology (copy_entries
    semantics — a plain data file stays a plain data file)."""
    return data.take(np.arange(min(num, data.n)))


def eveninit(
    data: Dataset,
    noc: int,
    knn: int = 5,
    proportional: bool = False,
    mode: str = "fast",
    device: Device = "cuda",
) -> Dataset:
    """Initial LVQ codebook: per-class quotas (even, or proportional to
    class frequency for propinit), vectors must fall inside class borders
    (init_codes, eveninit.c:46-158).  mode='fast' runs the self-kNN
    correctness sweep on `device` (chunked_topk: the same tie order,
    float32 products — for million-vector data); 'parity' on the host."""
    labels = data.first_labels()
    classes = Hitlist.from_labels(labels)
    nol = len(classes)
    tot = data.n
    nic = noc // nol

    for it in classes._items:
        if proportional:
            # C: freq = freq * (float)noc / tot, truncated to long, min 1
            q = int(F32(F32(it[1]) * F32(noc)) / F32(tot))
            it[1] = max(q, 1)
        else:
            it[1] = nic

    correct = knn_correct_mask(data, knn, mode=mode, device=device)
    picked = pick_inside_codes(classes, data, knn, correct)

    # second pass: redistribute the shortfall to classes that met their
    # quota (eveninit.c:114-144); fractional remainders carry over
    nom = len(picked)
    if nom < noc:
        emp = sum(1 for _, freq in classes.items() if freq == 0)
        frac = (noc - nom) / float(emp) if emp else 0.0
        err = 0.0
        for it in classes._items:
            if it[1] == 0:
                q = int(frac + err)
                err = frac + err - q
                it[1] = q
            else:
                it[1] = 0
        picked += pick_inside_codes(classes, data, knn, correct)

    out = data.take(np.asarray(picked, dtype=np.int64))
    out = replace(out, topol=Topology.LVQ)
    # codebooks keep only the class label of each picked vector
    if out.labels is not None:
        out.labels = out.labels[:, :1].copy()
    return out


# ---------------------------------------------------------------------------
# Class statistics (mindist/stddev/balance)
# ---------------------------------------------------------------------------

def class_nearest_stats(codes: Dataset, median: bool) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """Per-class mean (min_distances, lvq_rout.c:280-369) or median
    (med_distances :384-492) of each member's nearest *subsequent*
    same-class neighbor distance.  Returns (class_labels_in_hitlist_order,
    dists, counts)."""
    labels = codes.first_labels()
    classes = Hitlist.from_labels(labels)
    dmat = exact.pairwise_dist_euc(codes.points, codes.points, codes.mask, codes.mask)
    cls_labels = [lab for lab, _ in classes.items()]
    noe = np.asarray([freq for _, freq in classes.items()], dtype=np.int64)
    dists = np.zeros(len(cls_labels), dtype=F32)
    for ci, lab in enumerate(cls_labels):
        members = np.nonzero(labels == lab)[0]
        per_member = []
        for a_pos, a in enumerate(members):
            later = members[a_pos + 1:]
            if later.size == 0:
                continue
            per_member.append(dmat[a, later].min())
        if not per_member:
            continue
        arr = np.asarray(per_member, dtype=F32)
        if median:
            arr_sorted = np.sort(arr)
            dists[ci] = arr_sorted[len(arr_sorted) // 2]
        else:
            # C accumulates float32 in member order then divides by count
            s = F32(0.0)
            for v in arr:
                s = F32(s + v)
            dists[ci] = F32(s / F32(len(arr)))
    return cls_labels, dists, noe


def deviations(codes: Dataset, cls_labels: List[int], noe: np.ndarray) -> np.ndarray:
    """Per-class RMS deviation from the class centroid (lvq_rout.c:929-1004).
    Centroid sums skip masked components but divide by the class size."""
    labels = codes.first_labels()
    nol = len(cls_labels)
    dim = codes.dim
    avers = np.zeros((nol, dim), dtype=F32)
    for i in range(codes.n):
        ci = cls_labels.index(int(labels[i]))
        row = codes.points[i]
        if codes.mask is not None:
            keep = codes.mask[i] == 0
            avers[ci] = np.where(keep, (avers[ci] + row).astype(F32), avers[ci])
        else:
            avers[ci] = (avers[ci] + row).astype(F32)
    avers = (avers / noe[:, None].astype(F32)).astype(F32)
    devs = np.zeros(nol, dtype=F32)
    for i in range(codes.n):
        ci = cls_labels.index(int(labels[i]))
        d = (codes.points[i] - avers[ci]).astype(F32)
        s = F32(0.0)
        for v in (d * d).astype(F32):
            s = F32(s + v)
        devs[ci] = F32(devs[ci] + s)
    return np.sqrt((devs / noe.astype(F32)).astype(F32).astype(np.float64)).astype(F32)


BAL = 1.3  # balance.c:30


def balance(
    codes: Dataset,
    data: Dataset,
    knn: int = 5,
    alpha_file_out: Optional[str] = None,
    report=None,
) -> Dataset:
    """Rebalance per-class codebook counts using class-median distances,
    then one olvq1 pass over the data (balance_codes, balance.c:44-226).
    `report`: optional callable(line) receiving the per-class summary.
    Host parity only: its kNN sweep and olvq1 pass run mode="parity"."""
    cls_labels, dists, noe = class_nearest_stats(codes, median=True)
    nol = len(cls_labels)
    noe = noe.copy()
    diff = np.zeros(nol, dtype=np.int64)

    # aver = float32 mean of medians over classes with >1 member
    s = F32(0.0)
    note = 0
    for i in range(nol):
        if noe[i] > 1:
            s = F32(s + dists[i])
            note += 1
    aver = F32(s / F32(note)) if note else F32(0.0)

    note = 0
    for i in range(nol):
        # C compares in double: aver > 1.3 * dists[i]
        if float(aver) > BAL * float(dists[i]) and noe[i] > 1:
            diff[i] -= 1
            note += 1
        if BAL * float(aver) < float(dists[i]):
            diff[i] += 1
            note -= 1
    # (force-pick for empty classes, balance.c:109-121, is unreachable:
    #  the class list is built from the codebook so freq >= 1 always)
    for i in range(nol):
        if float(aver) > BAL * float(dists[i]) and (noe[i] + diff[i]) > 1:
            if note < 0:
                diff[i] -= 1
                note += 1
        if BAL * float(aver) < float(dists[i]):
            if note > 0:
                diff[i] += 1
                note -= 1

    # remove entries from classes with negative diff (file order scan)
    labels = codes.first_labels()
    keep = np.ones(codes.n, dtype=bool)
    rem = {cls_labels[i]: -int(d) for i, d in enumerate(diff) if d < 0}
    for i in range(codes.n):
        lab = int(labels[i])
        if rem.get(lab, 0) > 0:
            keep[i] = False
            rem[lab] -= 1
    kept = codes.take(np.nonzero(keep)[0])

    # pick additional inside-border vectors for positive diffs
    more = Hitlist()
    for i in range(nol):
        for _ in range(int(diff[i])):
            more.add_hit(cls_labels[i])
    picked = pick_inside_codes(more, data, knn, mode="parity")

    # the reference forgets to bump num_entries for the appended picks
    # (balance.c:187 'laske montako uutta'), so its olvq1 pass sizes the
    # alpha array and the .lra sidecar by the stale count.  The sidecar
    # length is observable file behavior (a short .lra makes the next
    # olvq1's alpha_read fail and fall back to 0.3) — replicate it.
    stale_noc = kept.n

    if picked:
        add = data.take(np.asarray(picked, dtype=np.int64))
        add = replace(add, topol=kept.topol)
        if add.labels is not None:
            add.labels = add.labels[:, :1].copy()
        kept = kept.concat(add)

    # one olvq1 pass: rlen = |data|, alpha = 0.3 (balance.c:195-202);
    # appended codes are frozen by the stale-count alpha array (see
    # olvq1_train's n_active)
    out, alphas = olvq1_train(kept, data, rlen=data.n, alpha=0.3, return_alphas=True,
                              n_active=stale_noc, mode="parity")
    if alpha_file_out is not None:
        from ..data.io import write_alpha_file

        write_alpha_file(alpha_file_out, alphas[:stale_noc])

    if report is not None:
        cls2, dists2, noe2 = class_nearest_stats(out, median=True)
        from ..data.labels import GLOBAL_LABELS

        for lab, d, ne in zip(cls2, dists2, noe2):
            report(
                "In class %9s %3d units, min dist.: %.3f"
                % (GLOBAL_LABELS.to_label(lab), ne, d)
            )
    return out


# ---------------------------------------------------------------------------
# Trainers — parity path
# ---------------------------------------------------------------------------

def _check_mode(mode: str) -> None:
    if mode not in ("parity", "fast"):
        raise ValueError(f"unknown mode {mode!r} (parity|fast)")


def _train_setup(codes, data, rlen, random_order, rng, buffer=0):
    if codes.dim != data.dim:
        raise ValueError("data and codebook dimensions differ")
    order = sample_order(data.n, rlen, random_order, rng, buffer=buffer)
    return order


def lvq1_train(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float,
    alpha_type: str = ALPHA_LINEAR,
    random_order: bool = False,
    rng: Optional[CRandom] = None,
    mode: str = "fast",
    snapshot=None,
    progress=None,
    buffer: int = 0,
    device: Device = "cuda",
) -> Dataset:
    """lvq1: move the 1-NN winner toward (label match) or away
    (lvq1_training, lvq_rout.c:498-577).  `snapshot`: interval hook
    (lvq_rout.c:559-567); `progress(remaining)`: the mprint hook; both
    parity only.  `data` may be a data.streaming.StreamingReader for
    bounded-memory training over huge files (parity mode; order
    identical to the full-load buffered path)."""
    _check_mode(mode)
    talpha = alpha_schedule(rlen, alpha, alpha_type)
    if _is_stream(data):
        def body(pts, clabels, le, chunk, s, dlab):
            x = chunk.points[s]
            xm = chunk.mask[s] if chunk.mask is not None else None
            w, _ = exact.find_winner_euc(x, pts, xm)
            a = talpha[le] if clabels[w] == dlab[s] else F32(-talpha[le])
            pts[w] = exact.adapt_vector(pts[w], x, a, xm)

        return _lvq_train_streamed(codes, data, rlen, random_order, rng,
                                   mode, body, snapshot, progress)
    order = _train_setup(codes, data, rlen, random_order, rng, buffer)
    if mode == "fast":
        return _lvq1_fast(codes, data, order, talpha, device)
    pts = codes.points.copy()
    clabels = codes.first_labels().copy()
    dlabels = data.first_labels()
    for le in range(rlen):
        if progress is not None:  # mprint hook (lvq_rout.c:570-571)
            progress(rlen - le)
        s = int(order[le])
        x = data.points[s]
        xm = data.mask[s] if data.mask is not None else None
        w, _ = exact.find_winner_euc(x, pts, xm)
        a = talpha[le] if clabels[w] == dlabels[s] else F32(-talpha[le])
        pts[w] = exact.adapt_vector(pts[w], x, a, xm)
        _maybe_snapshot(snapshot, le, codes, pts)
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def _lvq_train_streamed(codes, reader, rlen, random_order, rng, mode,
                        body, snapshot, progress):
    """Shared bounded-memory parity loop for the LVQ trainers over a
    StreamingReader (reference: training loops lvq_rout.c:498-916 over
    LOADMODE_BUFFER refills, datafile.c:237-344).  `body(pts, clabels,
    le, chunk, s, dlab)` mutates pts in place for one sample; sample order
    is index-identical to sample_order(..., buffer=B), so results are
    bit-equal to the full-load path."""
    if mode != "parity":
        raise ValueError(
            "streamed LVQ training is the bounded-memory parity path; "
            "for fast device training use LVQTrainer over chunk streams")
    if codes.dim != reader.dim:
        raise ValueError("data and codebook dimensions differ")
    from ..data.streaming import streamed_samples

    pts = codes.points.copy()
    clabels = codes.first_labels().copy()
    le = 0
    cur = None
    dlab = None
    for chunk, s in streamed_samples(reader, rlen, random_order, rng):
        if chunk is not cur:  # per-refill label gather, not per-sample
            cur = chunk
            dlab = chunk.first_labels()
        if progress is not None:
            progress(rlen - le)
        body(pts, clabels, le, chunk, s, dlab)
        _maybe_snapshot(snapshot, le, codes, pts)
        le += 1
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def olvq1_train(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float = 0.0,
    init_alphas: Optional[np.ndarray] = None,
    random_order: bool = False,
    rng: Optional[CRandom] = None,
    mode: str = "fast",
    return_alphas: bool = False,
    n_active: Optional[int] = None,
    snapshot=None,
    progress=None,
    buffer: int = 0,
    device: Device = "cuda",
):
    """olvq1: per-code adaptive learning rates — correct winner
    α←α/(1+α), wrong winner α←α/(1−α) clipped at the initial α
    (olvq1_training, lvq_rout.c:584-697).

    alpha==0 uses `init_alphas` (the .lra sidecar) or the default 0.3.

    `n_active`: codes at index >= n_active still compete in the winner
    search but are never adapted.  This replicates the reference balance
    bug: its stale num_entries sizes the alpha array short, so appended
    codes read heap garbage (zero/denormal) as their learning rate and
    are effectively frozen (balance.c:187, lvq_rout.c:614).
    """
    _check_mode(mode)
    streamed = _is_stream(data)
    if not streamed:
        order = _train_setup(codes, data, rlen, random_order, rng, buffer)
    if alpha == 0.0:
        if init_alphas is not None:
            # NOTE reference quirk (lvq_rout.c:666-672): when resuming
            # from a .lra file with alpha=0, the wrong-classification
            # clip `if (talpha > alpha) talpha = alpha` compares against
            # 0.0 — any wrongly-classifying winner has its learning rate
            # zeroed.  The lvqexample golden depends on this behavior.
            talpha = np.asarray(init_alphas, dtype=F32).copy()
            clip = F32(0.0)
        else:
            talpha = np.full(codes.n, 0.3, dtype=F32)
            clip = F32(0.3)
    else:
        talpha = np.full(codes.n, alpha, dtype=F32)
        clip = F32(alpha)
    if n_active is None:
        n_active = codes.n
    if streamed:
        def body(pts, clabels, le, chunk, s, dlab):
            x = chunk.points[s]
            xm = chunk.mask[s] if chunk.mask is not None else None
            w, _ = exact.find_winner_euc(x, pts, xm)
            if w >= n_active:
                return
            a = talpha[w]
            if clabels[w] == dlab[s]:
                pts[w] = exact.adapt_vector(pts[w], x, a, xm)
                talpha[w] = F32(a / F32(1.0 + a))
            else:
                pts[w] = exact.adapt_vector(pts[w], x, F32(-a), xm)
                na = F32(a / F32(1.0 - a))
                talpha[w] = min(na, clip)

        out = _lvq_train_streamed(codes, data, rlen, random_order, rng,
                                  mode, body, snapshot, progress)
        if return_alphas:
            return out, talpha
        return out
    if mode == "fast":
        out, talpha = _olvq1_fast(codes, data, order, talpha, clip, n_active, device)
    else:
        pts = codes.points.copy()
        clabels = codes.first_labels()
        dlabels = data.first_labels()
        for le in range(order.shape[0]):
            if progress is not None:  # mprint hook (lvq_rout.c:676-680)
                progress(order.shape[0] - le)
            s = int(order[le])
            x = data.points[s]
            xm = data.mask[s] if data.mask is not None else None
            w, _ = exact.find_winner_euc(x, pts, xm)
            if w >= n_active:
                continue
            a = talpha[w]
            if clabels[w] == dlabels[s]:
                pts[w] = exact.adapt_vector(pts[w], x, a, xm)
                talpha[w] = F32(a / F32(1.0 + a))
            else:
                pts[w] = exact.adapt_vector(pts[w], x, F32(-a), xm)
                na = F32(a / F32(1.0 - a))
                talpha[w] = min(na, clip)
            _maybe_snapshot(snapshot, le, codes, pts)
        if progress is not None:
            progress(0)
        out = replace(codes, points=pts, comments=[])
    if return_alphas:
        return out, talpha
    return out


def _lvq23_train(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float,
    winlen: float,
    epsilon: Optional[float],
    alpha_type: str,
    random_order: bool,
    rng: Optional[CRandom],
    snapshot=None,
    progress=None,
    buffer: int = 0,
    mode: str = "fast",
    device: Device = "cuda",
) -> Dataset:
    """Shared lvq2.1/lvq3 loop (lvq_rout.c:702-916). epsilon=None → lvq2."""
    _check_mode(mode)
    talpha = alpha_schedule(rlen, alpha, alpha_type)
    # C: (1-winlen)/(1+winlen) in float
    wl = F32(F32(1.0 - F32(winlen)) / F32(1.0 + F32(winlen)))
    if _is_stream(data):
        def body(pts, clabels, le, chunk, s, dlab):
            x = chunk.points[s]
            xm = chunk.mask[s] if chunk.mask is not None else None
            win_idx, win_d = exact.find_winner_knn(x, pts, 2, xm)
            b, nb = int(win_idx[0]), int(win_idx[1])
            ds_, nds = F32(win_d[0]), F32(win_d[1])
            lab, nlab, dlab_s = clabels[b], clabels[nb], dlab[s]
            a = talpha[le]
            if lab != nlab:
                if lab == dlab_s or nlab == dlab_s:
                    if F32(ds_ / nds) > wl:
                        if nlab == dlab_s:
                            b, nb = nb, b
                        pts[b] = exact.adapt_vector(pts[b], x, a, xm)
                        pts[nb] = exact.adapt_vector(pts[nb], x, F32(-a), xm)
            elif epsilon is not None:
                if lab == dlab_s:
                    ae = F32(a * F32(epsilon))
                    pts[b] = exact.adapt_vector(pts[b], x, ae, xm)
                    pts[nb] = exact.adapt_vector(pts[nb], x, ae, xm)

        return _lvq_train_streamed(codes, data, rlen, random_order, rng,
                                   mode, body, snapshot, progress)
    order = _train_setup(codes, data, rlen, random_order, rng, buffer)
    if mode == "fast":
        return _lvq23_fast(codes, data, order, talpha, winlen, epsilon, device)
    pts = codes.points.copy()
    clabels = codes.first_labels()
    dlabels = data.first_labels()
    for le in range(rlen):
        if progress is not None:
            progress(rlen - le)
        s = int(order[le])
        x = data.points[s]
        xm = data.mask[s] if data.mask is not None else None
        win_idx, win_d = exact.find_winner_knn(x, pts, 2, xm)
        b, nb = int(win_idx[0]), int(win_idx[1])
        ds_, nds = F32(win_d[0]), F32(win_d[1])
        lab, nlab, dlab = clabels[b], clabels[nb], dlabels[s]
        a = talpha[le]
        if lab != nlab:
            if lab == dlab or nlab == dlab:
                if F32(ds_ / nds) > wl:
                    if nlab == dlab:
                        b, nb = nb, b
                    pts[b] = exact.adapt_vector(pts[b], x, a, xm)
                    pts[nb] = exact.adapt_vector(pts[nb], x, F32(-a), xm)
        elif epsilon is not None:
            if lab == dlab:
                ae = F32(a * F32(epsilon))
                pts[b] = exact.adapt_vector(pts[b], x, ae, xm)
                pts[nb] = exact.adapt_vector(pts[nb], x, ae, xm)
        _maybe_snapshot(snapshot, le, codes, pts)
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def _maybe_snapshot(snapshot, le, codes_meta, pts):
    """Interval snapshot hook shared by the LVQ trainers
    (lvq_rout.c:559-567, :676-684): `snapshot(le, codebook)` every
    `snapshot.interval` steps."""
    if snapshot is not None and le > 0 and (le % snapshot.interval) == 0:
        snapshot(le, replace(codes_meta, points=pts.copy(), comments=[]))


def lvq2_train(codes, data, rlen, alpha, winlen, alpha_type=ALPHA_LINEAR,
               random_order=False, rng=None, mode="fast", snapshot=None,
               progress=None, buffer=0, device: Device = "cuda"):
    """lvq2.1 window-rule training (lvq_rout.c:702-803).  mode='fast'
    runs the device scan (_lvq23_fast); 'parity' is bit-exact."""
    return _lvq23_train(codes, data, rlen, alpha, winlen, None, alpha_type,
                        random_order, rng, snapshot, progress, buffer, mode, device)


def lvq3_train(codes, data, rlen, alpha, winlen, epsilon,
               alpha_type=ALPHA_LINEAR, random_order=False, rng=None,
               mode="fast", snapshot=None, progress=None, buffer=0,
               device: Device = "cuda"):
    """lvq3 training: lvq2.1 rule + same-class epsilon pull
    (lvq_rout.c:808-916).  mode='fast' runs the device scan."""
    return _lvq23_train(codes, data, rlen, alpha, winlen, epsilon, alpha_type,
                        random_order, rng, snapshot, progress, buffer, mode, device)


# ---------------------------------------------------------------------------
# Trainers — fast path (the per-sample scans on the device)
# ---------------------------------------------------------------------------

def _scan_blocks(codes: Dataset, data: Dataset, order, device: Device, *per_step):
    """Upload a scan's inputs once; returns (codebook, code labels, blocks):
    the codebook a float32 copy on `device` the scan updates in place, and
    an iterator of (samples, mask or None, sample labels, per-step slices)
    over the blocks of `common.scan_blocks` in `order`, `per_step` being
    (steps,) host arrays uploaded once too."""
    dev = torch.device(device)
    C = torch.tensor(np.asarray(codes.points, F32), device=dev)
    clab = torch.from_numpy(codes.first_labels().astype(np.int32)).to(dev)
    Xd = torch.from_numpy(np.ascontiguousarray(data.points, F32)).to(dev)
    Md = None if data.mask is None else torch.from_numpy(
        np.ascontiguousarray(data.mask)).to(dev)
    dlab = torch.from_numpy(data.first_labels().astype(np.int32)).to(dev)
    order_d = torch.from_numpy(np.asarray(order, np.int64)).to(dev)
    steps = [torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in per_step]
    blocks = ((xs, ms, dls, st)
              for (xs, ms, dls), st in scan_blocks(order_d, (Xd, Md, dlab), steps))
    return C, clab, blocks


def _lvq1_fast(codes: Dataset, data: Dataset, order, talpha, device: Device) -> Dataset:
    """The lvq1 scan of lvq.py:628-654 on `device`: each step's winner w
    is `dist_argmin` of the one sample (K1; K4 under a mask), then
    m_w += sign * (x - m_w), sign = a on a label match, else -a, masked
    components untouched."""
    C, clab, blocks = _scan_blocks(codes, data, order, device, np.asarray(talpha, F32))
    for xs, ms, dls, (a_blk,) in blocks:
        na_blk = -a_blk
        masked = None if ms is None else ms != 0
        for j in range(xs.shape[0]):
            x = xs[j:j + 1]
            _, w = dist_argmin(x, C, mask=None if ms is None else ms[j:j + 1])
            sign = torch.where(clab.index_select(0, w) == dls[j:j + 1], a_blk[j:j + 1],
                               na_blk[j:j + 1])
            delta = sign[:, None] * (x - C.index_select(0, w))
            if masked is not None:
                delta = torch.where(masked[j:j + 1], 0.0, delta)
            C.index_add_(0, w, delta)
    return replace(codes, points=C.cpu().numpy(), comments=[])


def _lvq23_fast(codes: Dataset, data: Dataset, order, talpha,
                winlen: float, epsilon: Optional[float], device: Device) -> Dataset:
    """The lvq2.1/lvq3 scan of lvq.py:657-712 on `device`: each step's
    winner pair (b, nb) with distances (ds, nds) is `dist_top2` of the one
    sample (K8; K9 under a mask).  The window rule, lab != nlab, one of
    them the sample's label and where(nds > 0, ds / nds, inf) > wl, moves
    the right-labelled one by +a and the other by -a; lvq3's epsilon rule
    (lab == nlab == the sample's) moves both by a * epsilon.  The two rules
    exclude each other, so each of the pair's rows takes one coefficient c
    (0 where no rule holds) and moves by (c * keep) * (x - m), both from
    the rows before the step, as the JAX scan computes its deltas."""
    wl = float(F32(F32(1.0 - F32(winlen)) / F32(1.0 + F32(winlen))))
    lvq3 = epsilon is not None
    eps = float(F32(epsilon)) if lvq3 else 0.0
    C, clab, blocks = _scan_blocks(codes, data, order, device, np.asarray(talpha, F32))
    # the pair's signs under the window rule: (+a, -a), or (-a, +a) when
    # the runner-up carries the sample's label
    pm = torch.tensor([1.0, -1.0], device=C.device)
    mp = -pm
    for xs, ms, dls, (a_blk,) in blocks:
        keep_blk = None if ms is None else 1.0 - ms.to(torch.float32)
        for j in range(xs.shape[0]):
            x = xs[j:j + 1]
            d1, i1, d2, i2 = dist_top2(x, C, mask=None if ms is None else ms[j:j + 1])
            pair = torch.cat([i1, i2])
            labs = clab.index_select(0, pair)
            lab, nlab, dl = labs[0:1], labs[1:2], dls[j:j + 1]
            a = a_blk[j:j + 1]
            in_win = torch.where(d2 > 0, d1 / torch.where(d2 > 0, d2, 1.0),
                                 float("inf")) > wl
            swap = nlab == dl
            window = (lab != nlab) & ((lab == dl) | swap) & in_win
            coef = torch.where(window, a * torch.where(swap, mp, pm), 0.0)
            if lvq3:
                coef = torch.where((lab == nlab) & (lab == dl), a * eps, coef)
            coef = coef[:, None]
            if keep_blk is not None:
                coef = coef * keep_blk[j:j + 1]
            C.index_add_(0, pair, coef * (x - C.index_select(0, pair)))
    return replace(codes, points=C.cpu().numpy(), comments=[])


def _olvq1_fast(codes: Dataset, data: Dataset, order, talpha0, clip, n_active,
                device: Device):
    """The olvq1 scan of lvq.py:715-747 on `device`: the winner w from
    `dist_argmin` (K1; K4 under a mask), m_w moved by +-alpha_w (x - m_w),
    alpha_w to a / (1 + a) on a label match, else min(a / (1 - a), clip);
    codes at w >= n_active keep their row and alpha.  The per-code alphas
    stay a device tensor.  Returns (codebook, alphas)."""
    C, clab, blocks = _scan_blocks(codes, data, order, device)
    al = torch.tensor(np.asarray(talpha0, F32), device=C.device)
    clip = float(clip)
    frozen = n_active < C.shape[0]
    for xs, ms, dls, _ in blocks:
        masked = None if ms is None else ms != 0
        for j in range(xs.shape[0]):
            x = xs[j:j + 1]
            _, w = dist_argmin(x, C, mask=None if ms is None else ms[j:j + 1])
            a = al.index_select(0, w)
            correct = clab.index_select(0, w) == dls[j:j + 1]
            delta = torch.where(correct, a, -a)[:, None] * (x - C.index_select(0, w))
            if masked is not None:
                delta = torch.where(masked[j:j + 1], 0.0, delta)
            new_a = torch.where(correct, a / (1.0 + a), torch.clamp(a / (1.0 - a), max=clip))
            if frozen:
                active = w < n_active
                delta = torch.where(active[:, None], delta, 0.0)
                new_a = torch.where(active, new_a, a)
            C.index_add_(0, w, delta)
            al.index_put_((w,), new_a)
    return (replace(codes, points=C.cpu().numpy(), comments=[]),
            al.cpu().numpy())
