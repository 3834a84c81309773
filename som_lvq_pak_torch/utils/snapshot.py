"""Snapshot checkpointing during training.

Replicates the reference snapshot subsystem (lvq_pak.c:663-867,
lvq_pak.h:150-184, types registered in datafile.c:1300-1308):

  * interval-based: trainers call the snapshot every `interval` steps
    (hook e.g. som_rout.c:650-658)
  * the filename is a printf pattern receiving the iteration number
    (`sprintf(filename, shot->filename, iter)`, lvq_pak.c:725)
  * types: 'file' (one file per snapshot), 'keepopen' (append every
    snapshot to one growing file delimited by `#start N` / `#end`,
    lvq_pak.c:730-764), 'async' (fork a background writer, waiting for
    the previous child first), 'async_nowait' (fork without waiting)
  * a trailing '&' on the filename also requests background writing
    (lvq_pak.c:814-819)
  * each snapshot records `#SNAPSHOT FILE` and `#iterations: i/total`
    (lvq_pak.c:747-748)

The port's copy of som_lvq_pak_tpu/utils/snapshot.py (all of it), on the
port's `format_header`/`format_entry`; tests read each of the four types
back through `read_snapshots` and hold the files equal to the JAX
CLI's.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO

SNAPSHOT_TYPES = ("file", "keepopen", "async", "async_nowait")


class Snapshot:
    """Callable checkpoint hook: `snap(iteration, codes_dataset)`.

    Trainers invoke it when `le > 0 and le % interval == 0`; `length`
    is the total training length recorded in the `#iterations:` line.
    """

    def __init__(
        self,
        filename: str,
        interval: int,
        stype: str = "file",
        length: int = 0,
        labels=None,
    ):
        if stype not in SNAPSHOT_TYPES:
            raise ValueError(f"Unknown snapshot type {stype}")
        self.background = stype in ("async", "async_nowait")
        self.nowait = stype == "async_nowait"
        self.keepopen = stype == "keepopen"
        if self.keepopen:
            self.nowait = False
        # trailing '&' in the filename also means background
        # (lvq_pak.c:814-819)
        if filename.endswith("&"):
            filename = filename[:-1]
            self.background = True
        self.filename = filename
        self.interval = int(interval)
        self.stype = stype
        self.length = int(length)
        self.labels = labels
        self.counter = 0
        self._fp: Optional[TextIO] = None
        self._pid: int = -1

    def __call__(self, iteration: int, codes) -> None:
        self.counter += 1
        fp = None
        if self.keepopen:
            if self._fp is None:
                self._fp = open(self.filename, "w")
            fp = self._fp

        if self.background and hasattr(os, "fork"):
            if self._pid > 0 and not self.nowait:
                # wait for the previous writer before forking a new one
                # (lvq_pak.c:691-702)
                try:
                    os.waitpid(self._pid, 0)
                except ChildProcessError:
                    pass
                self._pid = -1
            pid = os.fork()
            if pid > 0:
                self._pid = pid
                return
            # child: write and exit without running Python teardown
            try:
                self._write(fp, iteration, codes)
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
        else:
            self._write(fp, iteration, codes)

    def _write(self, fp: Optional[TextIO], iteration: int, codes) -> None:
        from ..data.io import format_entry, format_header

        close = False
        if fp is None:
            # the filename is a printf pattern receiving the iteration
            try:
                name = self.filename % iteration
            except TypeError:
                name = self.filename
            fp = open(name, "w")
            close = True
        try:
            if self.keepopen:
                fp.write("#start %d\n" % self.counter)
            fp.write(format_header(codes) + "\n")
            fp.write("#SNAPSHOT FILE\n#iterations: %d/%d\n" % (iteration, self.length))
            for i in range(codes.n):
                fp.write(format_entry(codes, i, self.labels) + "\n")
            if self.keepopen:
                fp.write("#end\n")
                fp.flush()
        finally:
            if close:
                fp.close()

    def close(self) -> None:
        """free_snapshot (lvq_pak.c:848-867): close the keepopen file and
        reap any pending background writer."""
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        if self._pid > 0 and not self.nowait:
            try:
                os.waitpid(self._pid, 0)
            except ChildProcessError:
                pass
            self._pid = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_snapshots(filename: str, labels=None):
    """Split a keepopen snapshot file back into the per-snapshot
    Datasets (the `#start N` / `#end` delimited sections)."""
    import io as _io

    from ..data.io import read_data

    out = []
    with open(filename) as f:
        text = f.read()
    chunks = text.split("#start ")
    for chunk in chunks[1:]:
        body = chunk.split("#end")[0]
        # drop the counter line, keep the rest verbatim
        _, _, rest = body.partition("\n")
        out.append(read_data("<snapshot>", labels=labels, fileobj=_io.StringIO(rest)))
    return out
