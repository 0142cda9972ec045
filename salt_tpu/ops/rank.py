"""Batched BWT rank (occ) queries as bit-plane gathers.

The reference answers occ(k, c) by pointer-chasing into interleaved
checkpoint blocks with per-call popcounts (Align_src/bwt.c:113-136,
rbwt.c:159-191).  The array re-expression: per symbol c keep a
bit-plane (one bit per BWT position) plus exclusive prefix counts at
every 32-bit word boundary.  A rank query is then two gathers + one
`population_count` — fully vectorizable over (reads x seeds x strands).

rank_excl(idx, c) = #occurrences of c in bwt[0 .. idx-1].

Both BWTs keep their sentinel in-band as a distinct symbol, which makes
the reference's `$`-skip adjustments (bwt.c:120, rbwt.c:165-167) fall
out: occ over the sentinel-stripped prefix equals rank_excl here.

LF mapping (backward-search step) for an interval [k, l] and symbol c:
    k' = C[c] + rank_excl(k, c) + 1
    l' = C[c] + rank_excl(l + 1, c)
which matches bwt_2occ-based stepping (bwt.c:281-309) and
Rbwt_exact_match_backward (rbwt.c:619-648) exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class RankIndex:
    """Bit-plane rank structure over a symbol array of length n.

    bc:   int32[n_sym * W, 2] per symbol plane and 32-symbol word
                              (flattened plane-major for 1D gathers):
                              [..,0] exclusive count at the word start,
                              [..,1] the bit word (bit i = sym[32w+i]==c)
                              fused so one gather serves a rank query
    cfreq: int32[n_sym + 1]   C-array: cfreq[c] = #symbols < c (sentinel
                              excluded, reference L2/cumulativeFreq)
    n: int                    number of symbols
    n_words: int              W
    """

    bc: jnp.ndarray
    cfreq: jnp.ndarray
    n: int
    n_words: int
    # row offset of this family's first plane row within `bc`.  Two
    # families can SHARE one concatenated plane array (C rows first,
    # then R rows) so per-lane mixed-family rank queries fuse into a
    # single gather (ops/locate.resolve_sampled) without duplicating
    # the planes in HBM; standalone indexes keep row_off = 0.
    row_off: int = 0

    def tree_flatten(self):
        return (self.bc, self.cfreq), (self.n, self.n_words, self.row_off)

    @classmethod
    def tree_unflatten(cls, aux, children):
        bc, cfreq = children
        return cls(bc=bc, cfreq=cfreq, n=aux[0], n_words=aux[1],
                   row_off=aux[2])


def build_rank_index(
    syms: np.ndarray, n_sym: int, cfreq: np.ndarray, sentinel: int
) -> RankIndex:
    """Host-side construction from a uint8 symbol array (sentinel in-band).

    `cfreq` must be the (n_sym+1)-long cumulative count array of the
    non-sentinel symbols (reference L2 / cumulativeFreq semantics).
    """
    n = len(syms)
    W = (n + 2 + 31) // 32 + 1  # allow rank queries at idx up to n+1
    bc = np.zeros((n_sym, W, 2), dtype=np.int32)
    # pad to exactly W*32 with a non-symbol so pad bits stay 0 in every
    # plane; packbits(bitorder="little") + <u4 view builds each plane at
    # memory bandwidth (the old bitwise_or.at scatter costs minutes at
    # whole-genome scale)
    pad = np.full(W * 32, 255, dtype=np.uint8)
    pad[:n] = syms
    for c in range(n_sym):
        mask = pad == c
        bits_c = np.packbits(mask, bitorder="little").view("<u4")
        per_word = mask.reshape(W, 32).sum(axis=1, dtype=np.int64)
        bc[c, 1:, 0] = np.cumsum(per_word)[:-1]
        bc[c, :, 1] = bits_c.view(np.int32)
    return RankIndex(
        bc=jnp.asarray(bc.reshape(n_sym * W, 2)),
        cfreq=jnp.asarray(cfreq.astype(np.int32)),
        n=n,
        n_words=W,
    )


@partial(jax.jit, static_argnames=("n", "n_sym", "n_words"))
def _device_rank_planes(words: jnp.ndarray, n: int, n_sym: int,
                        n_words: int) -> jnp.ndarray:
    """Device-side construction of the bc bit-plane array from 4-bit
    packed symbols (8 per uint32 word, little-endian) — bit-identical to
    build_rank_index's host loop.  Transfers n/2 bytes instead of the
    ~1.5n-byte plane array."""
    W = n_words
    # unpack to one nibble per symbol, padding (>= n) forced to 15
    # (matches no host symbol, so pad bits stay 0 in every plane)
    sh = jnp.arange(8, dtype=jnp.uint32) * 4
    nib = ((words[:, None].astype(jnp.uint32) >> sh) & 15).reshape(-1)
    pos = jnp.arange(nib.shape[0], dtype=jnp.int32)
    nib = jnp.where(pos < n, nib, jnp.uint32(15))
    # pad the symbol stream to exactly W*32 entries
    tot = W * 32
    nib = jnp.concatenate(
        [nib, jnp.full((max(tot - nib.shape[0], 0),), 15, jnp.uint32)]
    )[:tot].reshape(W, 32)
    bit_w = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    planes = []
    for c in range(n_sym):
        eq = nib == jnp.uint32(c)                    # (W, 32)
        bits = jnp.sum(jnp.where(eq, bit_w, 0), axis=-1, dtype=jnp.uint32)
        per_word = jax.lax.population_count(bits).astype(jnp.int32)
        excl = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(per_word)[:-1]]
        )
        planes.append(jnp.stack([excl, bits.astype(jnp.int32)], axis=-1))
    return jnp.concatenate(planes, axis=0)           # (n_sym*W, 2)


def build_rank_index_device(packed_words: jnp.ndarray, n: int, n_sym: int,
                            cfreq: np.ndarray) -> RankIndex:
    """RankIndex whose bc planes are built on device from packed syms."""
    W = (n + 2 + 31) // 32 + 1
    bc = _device_rank_planes(packed_words, n=n, n_sym=n_sym, n_words=W)
    return RankIndex(
        bc=bc,
        cfreq=jnp.asarray(cfreq.astype(np.int32)),
        n=n,
        n_words=W,
    )


def _plane_chunked_core(words: jnp.ndarray, c: int, n: int, n_words: int,
                        chunk: int = 1 << 18) -> jnp.ndarray:
    """One (W, 2) rank plane for symbol c, built on device in
    `chunk`-bit-word pieces — whole-genome texts (n >= 2^31) cannot
    materialize the flat nibble array the small-path builder uses
    (12GB+ transient), and shipping host-built planes costs ~1.5n
    bytes.  The packed symbol words are already a resident component in
    sampled mode, so this is transfer-free.
    Traced helper — callers jit it (alone or composed into the fused
    two-family cat build)."""
    W = n_words
    NC = (W + chunk - 1) // chunk
    need = NC * chunk * 4            # uint32 source words (8 syms each)
    wpad = jnp.concatenate([
        words.astype(jnp.uint32),
        jnp.full((max(need - words.shape[0], 0),), 0xFFFFFFFF, jnp.uint32),
    ])[:need]
    sh = jnp.arange(8, dtype=jnp.uint32) * 4
    bit_w = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    nu = jnp.uint32(n)

    def chunk_fn(ci):
        src = jax.lax.dynamic_slice(wpad, (ci * chunk * 4,), (chunk * 4,))
        nib = ((src[:, None] >> sh) & 15).reshape(-1)     # chunk*32
        gidx = (jnp.uint32(ci) * jnp.uint32(chunk * 32)
                + jnp.arange(chunk * 32, dtype=jnp.uint32))
        nib = jnp.where(gidx < nu, nib, jnp.uint32(15))
        eq = nib.reshape(chunk, 32) == jnp.uint32(c)
        bits = jnp.sum(jnp.where(eq, bit_w, 0), axis=-1, dtype=jnp.uint32)
        cnt = jax.lax.population_count(bits).astype(jnp.int32)
        return bits, cnt

    bits, cnt = jax.lax.map(chunk_fn, jnp.arange(NC, dtype=jnp.int32))
    bits = bits.reshape(-1)[:W]
    cnt = cnt.reshape(-1)[:W]
    excl = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt)[:-1]]
    )
    return jnp.stack([excl, bits.astype(jnp.int32)], axis=-1)


_device_plane_chunked = partial(jax.jit, static_argnames=(
    "c", "n", "n_words", "chunk"))(_plane_chunked_core)


def build_rank_index_device_chunked(packed_words: jnp.ndarray, n: int,
                                    n_sym: int,
                                    cfreq: np.ndarray) -> RankIndex:
    """Whole-genome-scale device plane build (per-symbol, chunked).
    Bit-identical to build_rank_index; bounded device transients."""
    W = (n + 2 + 31) // 32 + 1
    planes = [
        _device_plane_chunked(packed_words, c=c, n=n, n_words=W)
        for c in range(n_sym)
    ]
    return RankIndex(
        bc=jnp.concatenate(planes, axis=0),
        cfreq=jnp.asarray(np.asarray(cfreq).astype(np.int32)),
        n=n,
        n_words=W,
    )


@partial(jax.jit, static_argnames=("n_a", "n_sym_a", "n_words_a",
                                  "n_b", "n_sym_b", "n_words_b", "chunk"))
def _device_planes_cat_chunked(words_a, words_b, n_a, n_sym_a, n_words_a,
                               n_b, n_sym_b, n_words_b, chunk: int = 1 << 18):
    """Both families' rank planes in ONE concatenated array (family a's
    n_sym_a planes first), built in a single jit so XLA writes each
    plane straight into its slice of the output buffer — peak transient
    stays one cat array + one chunk, never two separate plane arrays
    plus their copy (matters at whole-genome scale on a 16GB chip)."""
    planes = [_plane_chunked_core(words_a, c, n_a, n_words_a, chunk)
              for c in range(n_sym_a)]
    planes += [_plane_chunked_core(words_b, c, n_b, n_words_b, chunk)
               for c in range(n_sym_b)]
    return jnp.concatenate(planes, axis=0)


def build_rank_index_pair_device_chunked(
    words_c: jnp.ndarray, n_c: int, n_sym_c: int, cfreq_c: np.ndarray,
    words_r: jnp.ndarray, n_r: int, n_sym_r: int, cfreq_r: np.ndarray,
):
    """Two RankIndex views over ONE shared concatenated plane array
    (C rows first).  rank_excl on either view is bit-identical to the
    standalone builders; mixed-family per-lane queries can gather from
    the shared array with a per-lane row offset (one gather instead of
    one per family — the sampled-SA locate walk's hot path)."""
    Wc = (n_c + 2 + 31) // 32 + 1
    Wr = (n_r + 2 + 31) // 32 + 1
    bc_cat = _device_planes_cat_chunked(
        words_c, words_r, n_a=n_c, n_sym_a=n_sym_c, n_words_a=Wc,
        n_b=n_r, n_sym_b=n_sym_r, n_words_b=Wr)
    ri_c = RankIndex(bc=bc_cat, cfreq=jnp.asarray(
        np.asarray(cfreq_c).astype(np.int32)), n=n_c, n_words=Wc)
    ri_r = RankIndex(bc=bc_cat, cfreq=jnp.asarray(
        np.asarray(cfreq_r).astype(np.int32)), n=n_r, n_words=Wr,
        row_off=n_sym_c * Wc)
    return ri_c, ri_r


def fuse_rank_index_pair(ri_c: RankIndex, ri_r: RankIndex):
    """Re-point two standalone RankIndexes at one concatenated plane
    array (small-index path; the big path builds fused directly)."""
    assert ri_c.row_off == 0 and ri_r.row_off == 0
    off = ri_c.bc.shape[0]
    bc_cat = jnp.concatenate([ri_c.bc, ri_r.bc], axis=0)
    return (
        RankIndex(bc=bc_cat, cfreq=ri_c.cfreq, n=ri_c.n,
                  n_words=ri_c.n_words),
        RankIndex(bc=bc_cat, cfreq=ri_r.cfreq, n=ri_r.n,
                  n_words=ri_r.n_words, row_off=off),
    )


def rank_excl(ri: RankIndex, idx: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Vectorized exclusive rank: #c in sym[0..idx-1].

    `idx` is a rank in [0, n+1] carried as int32 — for whole-genome
    texts (n >= 2^31) the value may be WRAPPED negative; all arithmetic
    on ranks is mod-2^32 correct, and this reads it back through uint32
    so the word index/shift come out right.  The returned count is a
    true int32 (per-symbol counts stay < 2^31 for any uint32 text)."""
    iu = idx.astype(jnp.uint32)
    w = (iu >> 5).astype(jnp.int32)          # < 2^27 for any uint32 text
    r = iu & 31
    row = ri.bc[ri.row_off + c * ri.n_words + w]  # (..., 2): one fused gather
    word = row[..., 1].astype(jnp.uint32)
    mask = jnp.where(r > 0, (jnp.uint32(1) << r) - jnp.uint32(1), jnp.uint32(0))
    partial_cnt = jax.lax.population_count(word & mask).astype(jnp.int32)
    return row[..., 0] + partial_cnt


def ugt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unsigned a > b for rank values carried (possibly wrapped) in
    int32 — the comparison every interval-emptiness test must use so
    whole-genome texts (ranks >= 2^31) order correctly."""
    return a.astype(jnp.uint32) > jnp.asarray(b).astype(jnp.uint32)


def umin(a: jnp.ndarray, b) -> jnp.ndarray:
    """Unsigned minimum on wrapped-int32 rank values; returns int32."""
    au = a.astype(jnp.uint32)
    bu = jnp.asarray(b).astype(jnp.uint32)
    return jnp.minimum(au, bu).astype(jnp.int32)


def lf_step(ri: RankIndex, k: jnp.ndarray, l: jnp.ndarray, c: jnp.ndarray):
    """One backward-search step; returns (k', l').  Interval is empty when
    k' > l' (compare with ugt: ranks may be wrapped)."""
    ok = rank_excl(ri, k, c)
    ol = rank_excl(ri, l + 1, c)
    base = ri.cfreq[c]
    return base + ok + 1, base + ol
