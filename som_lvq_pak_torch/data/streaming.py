"""Buffered streaming loader — the reference's LOADMODE_BUFFER rebuilt
as a host input pipeline.

The reference streams huge files by refilling a linked-list buffer of
`buffer` entries at a time inside next_entry, rewinding (re-opening a
compressed stream if needed) at end of file each training lap
(read_entries, datafile.c:237-344; next_entry/rewind_entries,
datafile.c:754-840).

Here the same contract is a chunk iterator over Dataset slices with a
background prefetch thread, so host parsing overlaps device compute.

The port's copy of som_lvq_pak_tpu/data/streaming.py:StreamingReader and
`streamed_samples` (:212-266); its chunks parse with the port's Python
parser (data.io.read_data), and tests hold them, and the sample order, equal
to the JAX package's.
"""

from __future__ import annotations

import io as _io
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from ..config import masked_string
from .dataset import Dataset
from .io import _open_read, parse_header, read_data
from .labels import GLOBAL_LABELS, LabelTable


class StreamingReader:
    """Iterate a data file `buffer` entries at a time.

    Each iteration yields a Dataset carrying the file's header metadata;
    `laps` controls how many passes over the file are made (None =
    iterate forever, the trainer's wrap-around semantics)."""

    def __init__(
        self,
        name: str,
        buffer: int,
        labels: Optional[LabelTable] = None,
        skip_empty: bool = True,
        prefetch: int = 2,
        shard: Optional[tuple] = None,
    ):
        """`shard=(k, n)` keeps only every n-th entry starting at k — the
        data-parallel split: process k of n streams its own 1/n of the
        file."""
        if buffer <= 0:
            raise ValueError("buffer must be positive")
        if shard is not None:
            k, n = shard
            if not (0 <= k < n):
                raise ValueError(f"bad shard {shard}")
        self.name = name
        self.buffer = buffer
        self.labels = labels if labels is not None else GLOBAL_LABELS
        self.skip_empty = skip_empty
        self.prefetch = prefetch
        self.shard = shard
        # parse the header once up front
        f = _open_read(name)
        try:
            header = None
            self.comments: List[str] = []
            for raw in f:
                line = raw.rstrip("\n")
                if not line.strip():
                    continue
                if line.startswith("#"):
                    self.comments.append(line)
                    continue
                header = line
                break
            if header is None:
                raise ValueError(f"{name}: no header line")
            self.header = header
            (self.dim, self.topol, self.neigh, self.xdim, self.ydim) = parse_header(header)
        finally:
            if hasattr(f, "close"):
                f.close()

    # -- single lap ------------------------------------------------------

    def _counts_toward_buffer(self, raw: str) -> bool:
        """Does this data line yield a LOADED entry?  The reference's
        refill loop counts ACCEPTED entries, not lines (read_entries
        keeps reading until `buffer` entries loaded, datafile.c:237-344;
        all-masked lines are skipped by load_entry and do not count,
        :676-686) — so refill boundaries, and hence the per-refill
        shuffle order, must not count skipped empties either."""
        if not self.skip_empty:
            return True
        mstr = self._mstr
        if mstr not in raw:  # fast path: no mask token on the line
            return True
        toks = raw.split()
        return not (len(toks) >= self.dim
                    and all(t == mstr for t in toks[: self.dim]))

    def _chunks_one_lap(self) -> Iterator[Dataset]:
        self._mstr = masked_string()
        n_seen = 0
        f = _open_read(self.name)  # rewind = re-open (fileio.c:383-426)
        try:
            # skip past the header
            for raw in f:
                line = raw.rstrip("\n")
                if not line.strip() or line.startswith("#"):
                    continue
                break
            lines: List[str] = []
            loaded = 0  # ACCEPTED entries in the pending refill
            row = 0
            k, n = self.shard if self.shard is not None else (0, 1)
            for raw in f:
                if raw.startswith("#"):
                    continue
                if not raw.strip():
                    continue
                keep = row % n == k
                row += 1
                if not keep:
                    continue
                lines.append(raw)
                if self._counts_toward_buffer(raw):
                    loaded += 1
                if loaded >= self.buffer:
                    chunk = self._parse_chunk(lines)
                    n_seen += chunk.n
                    yield chunk
                    lines = []
                    loaded = 0
            if lines:
                chunk = self._parse_chunk(lines)
                n_seen += chunk.n
                if chunk.n:
                    yield chunk
            # entry count of the last COMPLETE lap (empties excluded) —
            # lets one-lap consumers report the sample count without a
            # second pass over the file
            self.entries_last_lap = n_seen
        finally:
            if hasattr(f, "close"):
                f.close()

    def _parse_chunk(self, lines: List[str]) -> Dataset:
        text = self.header + "\n" + "".join(lines)
        return read_data("<chunk>", labels=self.labels, skip_empty=self.skip_empty,
                         fileobj=_io.StringIO(text))

    # -- iteration with prefetch ----------------------------------------

    def chunks(self, laps: Optional[int] = 1) -> Iterator[Dataset]:
        """Yield chunk Datasets, prefetching ahead on a worker thread."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        SENTINEL = object()

        def producer():
            try:
                lap = 0
                while laps is None or lap < laps:
                    for chunk in self._chunks_one_lap():
                        if stop.is_set():
                            return
                        q.put(chunk)
                    lap += 1
                q.put(SENTINEL)
            except BaseException as e:  # surface parse errors to consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def __iter__(self) -> Iterator[Dataset]:
        return self.chunks(laps=1)


def streamed_samples(reader: StreamingReader, rlen: int,
                     random_order: bool = False, rng=None):
    """Yield (chunk Dataset, row) pairs for `rlen` training samples in
    the reference's buffered order with bounded memory — the sample-level
    contract of next_entry over LOADMODE_BUFFER (datafile.c:754-840):

    * each refill holds `buffer` entries; with random_order the refill
      is shuffled with the CONTINUING LCG stream (datafile.c:268-270,
      338-341) — `rng` must be the same CRandom the full-load path
      would use, so the order matches models.common.sample_order(...,
      buffer=B) index-for-index;
    * every lap rewinds (re-opens) the file and reloads all chunks;
    * a file that fits one refill (n < buffer) switches buffering OFF
      after the first load (datafile.c:330-333): the first shuffle is
      kept and cycled, with no further LCG draws — LOADMODE_ALL
      semantics.  n == buffer stays buffered (reshuffled every lap).

    Memory: one parsed chunk at a time (~buffer entries), however large
    the file or rlen.  NB chunk boundaries count data LINES; all-masked
    (skip_empty) entries are dropped after chunking, so files containing
    empty entries get slightly different refill boundaries than the
    reference's count-after-skip loader."""
    if random_order and rng is None:
        raise ValueError("random_order needs the CRandom stream")
    le = 0
    all_mode = None  # (chunk, order) once the whole file fit one refill
    while le < rlen:
        if all_mode is not None:
            chunk, order = all_mode
            for pos in order:
                if le >= rlen:
                    return
                yield chunk, int(pos)
                le += 1
            continue
        nchunks = 0
        last = last_order = None
        for chunk in reader._chunks_one_lap():
            nchunks += 1
            if random_order:
                order = rng.shuffle_order(chunk.n)
            else:
                order = np.arange(chunk.n)
            for pos in order:
                if le >= rlen:
                    return
                yield chunk, int(pos)
                le += 1
            last, last_order = chunk, order
        if nchunks == 0:
            raise ValueError(f"{reader.name}: no data entries")
        if nchunks == 1 and last.n < reader.buffer:
            all_mode = (last, last_order)
