"""Bit-exact replica of the reference package's private LCG RNG.

The reference (lvq_pak.c:459-484) uses its own deterministic generator so
that every pipeline is reproducible:

    static unsigned long next = 1;
    void osrand(int i)  { next = i; }
    long orand()        { return (int)((next = (next * 23) % 100000001) % 32767); }
    void init_random(int seed) { osrand(seed ? seed : time(NULL)); }

Seeds, codebook randinit, and per-lap data shuffles all draw from this
stream.  We replicate it on the host (it is cheap scalar work) so that
framework runs at equal seed produce bit-identical initial codebooks and
sample orders to the C package; device-side RNG (torch.Generator) is used
only for the non-parity fast paths.

The port's copy of som_lvq_pak_tpu/utils/rng.py; tests hold the streams
equal.
"""

from __future__ import annotations

import time

import numpy as np

RND_MAX = 32767  # reference lvq_pak.c:461 (modulus, so outputs are 0..32766)
_MOD = 100000001
_MUL = 23


class CRandom:
    """The reference LCG. Streams are tiny; this is plain Python ints."""

    def __init__(self, seed: int = 1):
        self.osrand(seed)

    def osrand(self, seed: int) -> None:
        # C: `next = i` where next is unsigned long (64-bit) and i is int.
        # A negative int wraps modulo 2**64.
        self.state = seed % (1 << 64)

    def init_random(self, seed: int) -> None:
        """Seed 0 means wall-clock time (reference lvq_pak.c:478-484)."""
        self.osrand(seed if seed else int(time.time()))

    def orand(self) -> int:
        # C computes `next * 23` in unsigned long: the product wraps mod
        # 2**64 *before* the % 100000001 (matters only for huge seeds).
        self.state = ((self.state * _MUL) % (1 << 64)) % _MOD
        return self.state % RND_MAX

    def uniform(self) -> float:
        """orand()/32768.0 as used by randinit_codes (som_rout.c:146-147)."""
        return self.orand() / 32768.0

    def orand_array(self, n: int) -> np.ndarray:
        """Draw n consecutive orand() values as an int64 array."""
        out = np.empty(n, dtype=np.int64)
        s = self.state
        for i in range(n):
            s = ((s * _MUL) % (1 << 64)) % _MOD
            out[i] = s % RND_MAX
        self.state = s
        return out

    def shuffle_order(self, n: int) -> np.ndarray:
        """Permutation produced by the reference's randomize_entry_order.

        datafile.c:1166-1187: table of n entries; for i in 0..n-1:
        j = orand() % n; swap(tbl[i], tbl[j]).  Returns the index order
        such that new_list[k] = old_list[order[k]].
        """
        tbl = np.arange(n, dtype=np.int64)
        draws = self.orand_array(n)
        for i in range(n):
            j = int(draws[i]) % n
            tbl[i], tbl[j] = tbl[j], tbl[i]
        return tbl
