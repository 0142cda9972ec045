"""Batched candidate verification and best-hit selection.

Ungapped check (alnse_check_nogap, Align_src/alnse.c:734-782): per
candidate position, count read bases whose one-hot code ANDs to zero
against the 4-bit mixRef nibble (ed_mismatch, editdistance.c:88-163).
Counts are exact up to the ungapped threshold (3) and clamped above it,
which is all the sequential replay below can observe.

The reference scans sorted candidates strand 0 then strand 1 with a
shrinking threshold captured by the code_kmismatch macro
(alnse.c:348-369, 1079-1083).  That sequence is replayed exactly in
vector form:

  t_i   = min(3, exclusive-prefix-min of checked counts)     [threshold]
  hit_i = checked_i and counts_i <= t_i                      [recorded]

and the primary is the winning strand's first-minimum hit, where a
strand-1 hit always displaces an equal strand-0 best because the C code
resets `flag_match` per strand call (alnse.c:412,751).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import NOGAP_MAX_DIFF, UINT32_MAX
from .locate import Loci

NT2BIT = jnp.array([1, 2, 4, 8, 15], dtype=jnp.uint8)

BIG = jnp.int32(255)


class StrandVerify(NamedTuple):
    counts: jnp.ndarray    # int32 (B, CAP) clamped mismatch counts
    checked: jnp.ndarray   # bool  (B, CAP) in-range, deduped
    pos: jnp.ndarray       # uint32 (B, CAP) sorted positions


class SEResult(NamedTuple):
    found: jnp.ndarray        # bool (B,)
    pos: jnp.ndarray          # uint32 (B,)
    strand: jnp.ndarray       # int32 (B,)
    n_diff: jnp.ndarray       # int32 (B,)
    # per-strand hit lists (sorted-candidate order), first K compacted
    hits_pos: jnp.ndarray     # uint32 (B, 2, K)
    hits_ndiff: jnp.ndarray   # int32 (B, 2, K)
    n_hits: jnp.ndarray       # int32 (B, 2) total hits (may exceed K)
    first_hit_ndiff: jnp.ndarray  # int32 (B, 2) n_diff of each strand's a[0]


def checked_mask(loci: Loci, l_mref: int) -> jnp.ndarray:
    """In-range + adjacent-dedup mask over sorted loci
    (alnse_check_nogap skip rule, alnse.c:762)."""
    B = loci.pos.shape[0]
    pos = loci.pos
    in_range = loci.pushed & (pos < jnp.uint32(l_mref))
    prev = jnp.concatenate(
        [jnp.full((B, 1), UINT32_MAX, dtype=pos.dtype), pos[:, :-1]], axis=1
    )
    return in_range & (pos != prev)


def compact_loci(loci: Loci, checked: jnp.ndarray, u: int):
    """Keep the first `u` checked slots per read (order preserved):
    slot i gathers the (i+1)-th checked candidate, found by a per-row
    search over the running checked count (no scatter).
    Returns (pos (B,u) uint32, keep (B,u) bool, overflow (B,) bool)."""
    B, CAP = checked.shape
    csum = jnp.cumsum(checked.astype(jnp.int32), axis=-1)
    n_checked = csum[:, -1]
    ranks = jnp.arange(1, u + 1, dtype=jnp.int32)
    # index of the rank-th checked slot = #{j : csum[j] < rank}
    # (searchsorted side="left" as an all-compare reduction).  The
    # compare is chunked through a fori_loop so no (B, u, CAP)
    # intermediate is materialized.
    CH = 128
    if CAP % CH or CAP <= CH:
        src = jnp.sum(
            csum[:, None, :] < ranks[None, :, None], axis=-1,
            dtype=jnp.int32,
        )                                                # (B, u)
    else:
        def body(i, acc):
            sl = jax.lax.dynamic_slice_in_dim(csum, i * CH, CH, axis=1)
            return acc + jnp.sum(
                sl[:, None, :] < ranks[None, :, None], axis=-1,
                dtype=jnp.int32,
            )

        src = jax.lax.fori_loop(
            0, CAP // CH, body, jnp.zeros((B, u), jnp.int32)
        )
    keep = ranks[None, :] <= n_checked[:, None]
    pos = jnp.take_along_axis(loci.pos, jnp.clip(src, 0, CAP - 1), axis=-1)
    pos = jnp.where(keep, pos, jnp.asarray(UINT32_MAX, dtype=loci.pos.dtype))
    # A checked pos of exactly 0xFFFFFFFF (wraparound pos == -1 passing
    # the gapped end-check) is conflated with the absent sentinel, which
    # is equivalent — such a candidate fails the ungapped in-range rule
    # by construction and is masked by in_ref in the gapped verify, so
    # its count is unobservable either way.
    keep = pos != jnp.asarray(UINT32_MAX, dtype=loci.pos.dtype)
    return pos, keep, n_checked > u


def mismatch_counts_packed(
    mixref_words: jnp.ndarray,  # uint32 [ceil(l_mref/8)+pad] little-endian nibbles
    pos: jnp.ndarray,           # uint32 (B, U) compacted candidate positions
    keep: jnp.ndarray,          # bool (B, U)
    seq: jnp.ndarray,           # (B, L) codes for this strand
    clamp: int,
) -> StrandVerify:
    """Word-packed ed_mismatch: gathers ~L/8 uint32 words per candidate,
    then counts nonzero AND-nibbles with a bit trick + popcount — fully
    word-parallel on the VPU, no per-nibble unpacking.

    The read's one-hot pattern is pre-packed into words at each of the 8
    possible nibble alignments ONCE PER READ (not per candidate); each
    candidate selects its alignment row, ANDs against the gathered
    reference words, reduces any-bit-per-nibble to bit0 (x|x>>1|x>>2|x>>3
    folded to two shifts), masks with 0x11111111 and popcounts.  Pattern
    nibbles outside the read span are zero, so they AND to zero and the
    mismatch count is simply L - matches."""
    B, U = pos.shape
    L = seq.shape[-1]
    NW = (L + 7 + 7) // 8 + 1          # words covering any alignment
    NP = NW * 8
    # shift through uint32: positions >= 2^31 (whole-genome mixRef)
    # must not arithmetic-shift as wrapped int32
    base = jnp.where(keep, pos, jnp.uint32(0)).astype(jnp.uint32)
    wstart = (base >> 3).astype(jnp.int32)   # word index < 2^29
    align = (base & 7).astype(jnp.int32)
    widx = wstart[..., None] + jnp.arange(NW, dtype=jnp.int32)
    widx = jnp.clip(widx, 0, mixref_words.shape[0] - 1)
    words = mixref_words[widx].astype(jnp.uint32)       # (B, U, NW)

    bits = NT2BIT[jnp.clip(seq, 0, 4)].astype(jnp.uint32)   # (B, L)
    a8 = jnp.arange(8, dtype=jnp.int32)
    j = jnp.arange(NP, dtype=jnp.int32)
    # pat nibble stream at alignment a: bits[b, j - a] inside the span
    rel = j[None, :] - a8[:, None]                       # (8, NP)
    valid = (rel >= 0) & (rel < L)
    relc = jnp.clip(rel, 0, L - 1)
    pat8 = jnp.where(valid[None], bits[:, relc], 0)      # (B, 8, NP)
    # pack 8 little-endian nibbles per uint32 word
    sh = (jnp.arange(8, dtype=jnp.uint32) * 4)
    pat8w = jnp.sum(
        pat8.reshape(B, 8, NW, 8) << sh, axis=-1, dtype=jnp.uint32
    )                                                    # (B, 8, NW)

    pat_sel = jnp.take_along_axis(pat8w, align[:, :, None], axis=1)  # (B,U,NW)
    x = words & pat_sel
    t = x | (x >> 1)
    t = (t | (t >> 2)) & jnp.uint32(0x11111111)
    matches = jnp.sum(
        jax.lax.population_count(t), axis=-1, dtype=jnp.int32
    )                                                    # (B, U)
    counts = jnp.minimum(L - matches, clamp)
    counts = jnp.where(keep, counts, BIG)
    return StrandVerify(counts=counts, checked=keep, pos=pos)


def mismatch_counts(
    mixref: jnp.ndarray,    # uint8 [l_mref]
    loci: Loci,             # sorted
    seq: jnp.ndarray,       # (B, L) codes for this strand
    l_mref: int,
    clamp: int = NOGAP_MAX_DIFF + 1,
) -> StrandVerify:
    """Mismatch counts for each pushed locus; dedup + range rules of
    alnse_check_nogap (skip pos == previous checked pos or pos >= l_mref)."""
    B, CAP = loci.pos.shape
    L = seq.shape[-1]
    pos = loci.pos
    in_range = loci.pushed & (pos < jnp.uint32(l_mref))
    prev = jnp.concatenate(
        [jnp.full((B, 1), UINT32_MAX, dtype=pos.dtype), pos[:, :-1]], axis=1
    )
    # loci are sorted, so equal positions are adjacent; the reference
    # only dedups against the previous *checked* pos, but since checked
    # positions form a sorted subsequence this is equivalent.
    checked = in_range & (pos != prev)

    base = jnp.where(checked, pos, 0).astype(jnp.int32)
    gather_idx = base[..., None] + jnp.arange(L, dtype=jnp.int32)
    gather_idx = jnp.clip(gather_idx, 0, l_mref - 1)
    nibs = mixref[gather_idx]                     # (B, CAP, L)
    bits = NT2BIT[jnp.clip(seq, 0, 4)][:, None, :]  # (B, 1, L)
    mism = (nibs & bits) == 0
    counts = jnp.minimum(jnp.sum(mism, axis=-1, dtype=jnp.int32), clamp)
    counts = jnp.where(checked, counts, BIG)
    return StrandVerify(counts=counts, checked=checked, pos=pos)


def replay_and_select(
    v0: StrandVerify,
    v1: StrandVerify,
    max_diff0: int,
    k_hits: int,
) -> SEResult:
    """Sequential threshold replay over strand-0-then-strand-1 candidates
    and primary selection, fully vectorized."""
    B, CAP = v0.counts.shape
    counts = jnp.concatenate([v0.counts, v1.counts], axis=-1)   # (B, 2CAP)
    checked = jnp.concatenate([v0.checked, v1.checked], axis=-1)
    pos = jnp.concatenate([v0.pos, v1.pos], axis=-1)

    cmin = jnp.minimum(counts, BIG)
    run_min = jax.lax.associative_scan(jnp.minimum, cmin, axis=-1)
    excl_min = jnp.concatenate(
        [jnp.full((B, 1), BIG), run_min[:, :-1]], axis=-1
    )
    t = jnp.minimum(jnp.int32(max_diff0), excl_min)
    hit = checked & (counts <= t)

    def strand_best(cs, hs):
        val = jnp.min(jnp.where(hs, cs, BIG), axis=-1)
        first = jnp.argmax(hs & (cs == val[:, None]), axis=-1)
        has = jnp.any(hs, axis=-1)
        return has, val, first

    has0, val0, idx0 = strand_best(counts[:, :CAP], hit[:, :CAP])
    has1, val1, idx1 = strand_best(counts[:, CAP:], hit[:, CAP:])
    # strand 1's first hit displaces an equal strand-0 best (flag reset)
    use1 = has1
    found = has0 | has1
    best_strand = jnp.where(use1, 1, 0)
    best_val = jnp.where(use1, val1, val0)
    best_pos = jnp.where(
        use1,
        jnp.take_along_axis(v1.pos, idx1[:, None], axis=-1)[:, 0],
        jnp.take_along_axis(v0.pos, idx0[:, None], axis=-1)[:, 0],
    )

    def compact(hs, cs, ps):
        # first-k compaction by rank selection (see compact_loci)
        csum = jnp.cumsum(hs.astype(jnp.int32), axis=-1)
        ranks = jnp.arange(1, k_hits + 1, dtype=jnp.int32)
        src = jnp.sum(
            csum[:, None, :] < ranks[None, :, None], axis=-1,
            dtype=jnp.int32,
        )
        hsel = ranks[None, :] <= csum[:, -1:]
        take = lambda a: jnp.take_along_axis(
            a, jnp.clip(src, 0, hs.shape[-1] - 1), axis=-1)
        hp = jnp.where(hsel, take(ps), jnp.uint32(UINT32_MAX))
        hn = jnp.where(hsel, take(cs), BIG)
        n = csum[:, -1]
        fh = jnp.where(
            jnp.any(hs, axis=-1),
            jnp.take_along_axis(cs, jnp.argmax(hs, axis=-1)[:, None], axis=-1)[:, 0],
            BIG,
        )
        return hp, hn, n, fh

    hp0, hn0, n0, fh0 = compact(hit[:, :CAP], v0.counts, v0.pos)
    hp1, hn1, n1, fh1 = compact(hit[:, CAP:], v1.counts, v1.pos)

    return SEResult(
        found=found,
        pos=jnp.where(found, best_pos, jnp.uint32(UINT32_MAX)),
        strand=best_strand,
        n_diff=jnp.where(found, best_val, BIG),
        hits_pos=jnp.stack([hp0, hp1], axis=1),
        hits_ndiff=jnp.stack([hn0, hn1], axis=1),
        n_hits=jnp.stack([n0, n1], axis=1),
        first_hit_ndiff=jnp.stack([fh0, fh1], axis=1),
    )
