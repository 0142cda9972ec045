"""Device-resident index arrays derived from a host SaltIndex."""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import UINT32_MAX
from ..index.build import SaltIndex
from ..ops.rank import RankIndex


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceIndex:
    ri_c: RankIndex       # C-part rank structure (5 symbols incl. sentinel)
    ri_r: RankIndex       # R-part rank structure (6 symbols incl. sentinel)
    lkt: jnp.ndarray      # uint32 [4^12+1]
    r_lkt_sp: jnp.ndarray # uint32 [4^12] exact R 12-mer intervals
    r_lkt_ep: jnp.ndarray
    sa_cat: jnp.ndarray   # uint32 [c_sa_len + T+1]: csa then r_coord,
                          # fused so locate is ONE gather per slot
    mixref_words: jnp.ndarray  # uint32 [ceil(L/8)+2] little-endian 4-bit
                          # one-hot nibbles (the only device-resident
                          # mixRef form; byte windows unpack on the fly)
    l_pac: int
    l_seed: int
    c_sa_len: int         # length of the csa part within sa_cat

    def tree_flatten(self):
        return (
            (
                self.ri_c, self.ri_r, self.lkt, self.r_lkt_sp, self.r_lkt_ep,
                self.sa_cat, self.mixref_words,
            ),
            (self.l_pac, self.l_seed, self.c_sa_len),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        (ri_c, ri_r, lkt, r_lkt_sp, r_lkt_ep, sa_cat,
         mixref_words) = children
        return cls(
            ri_c=ri_c, ri_r=ri_r, lkt=lkt, r_lkt_sp=r_lkt_sp,
            r_lkt_ep=r_lkt_ep, sa_cat=sa_cat,
            mixref_words=mixref_words, l_pac=aux[0], l_seed=aux[1],
            c_sa_len=aux[2],
        )


def pack_nibbles(mixref: np.ndarray) -> np.ndarray:
    """uint8 nibbles -> uint32 words, little-endian within the word
    (matches the mixRef pac layout, metaref.c:54-56)."""
    n = len(mixref)
    W = (n + 7) // 8 + 2
    padded = np.zeros(W * 8, dtype=np.uint32)
    padded[:n] = mixref
    words = np.zeros(W, dtype=np.uint32)
    for j in range(8):
        words |= padded[j::8] << np.uint32(4 * j)
    return words


@jax.tree_util.register_pytree_node_class
@dataclass
class SampledSA:
    """Memory-lean locate tables (sa_mode="sampled"): instead of the
    full per-rank coordinate table (4 bytes/rank over genome + pattern
    text — the dominant HBM cost at GRCh38 scale), store

      * C part: positions sampled by TEXT position (pos % intv == 0),
        compacted in rank order, plus a fused (count, bitword) select
        structure over ranks — a locate LF-walks at most intv-1 steps
        (text sampling bounds the walk, unlike BWA's rank sampling)
      * R part: coordinates only at '#' ranks.  All '#'-starting
        suffixes sort into one contiguous rank interval, so the slot is
        k - sharp_lo with no select structure; a locate LF-walks to the
        segment's leading '#' (bounded by the longest local pattern)
      * 4-bit packed BWT symbol words for both parts (walk steps read
        the symbol to apply LF)

    HBM cost ~ n/3 bytes instead of 4n — GRCh38 + snp144Common fits a
    single 16GB chip.
    """

    # C and R structures are CONCATENATED (C first) so each walk
    # iteration pays one fused gather per structure with a per-lane
    # family offset, instead of one per family (resolve_sampled is
    # gather-bound; fusing cut its per-iteration gathers 6 -> 4).
    #
    # Stop ranks: C — text position % intv == 0 (value = position);
    # R — '#' ranks (value = sharp coordinate base) AND ranks whose
    # coordinate % intv == 0 (value = that coordinate; coordinates
    # decrease by 1 per LF step inside a segment, so every walk stops
    # within intv-1 steps for BOTH families).
    sel_cat: jnp.ndarray      # int32 [Wc+Wr, 2] fused (excl-count, bits)
    samples_cat: jnp.ndarray  # uint32 stop values, C block then R block
    syms_cat: jnp.ndarray     # uint32 4-bit packed BWT syms, C then R
    c_words: int              # word count of the C block in syms_cat
    c_sel_rows: int           # row count of the C block in sel_cat
    c_n_samples: int          # value count of the C block
    sharp_lo: int             # first '#' rank (r_cumfreq[4] + 1)
    sharp_hi: int             # one past last '#' rank
    intv: int
    max_r_walk: int           # walk bound (== intv)

    def tree_flatten(self):
        return (
            (self.sel_cat, self.samples_cat, self.syms_cat),
            (self.c_words, self.c_sel_rows, self.c_n_samples,
             self.sharp_lo, self.sharp_hi, self.intv, self.max_r_walk),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        sel_cat, samples_cat, syms_cat = children
        return cls(sel_cat=sel_cat, samples_cat=samples_cat,
                   syms_cat=syms_cat, c_words=aux[0], c_sel_rows=aux[1],
                   c_n_samples=aux[2], sharp_lo=aux[3], sharp_hi=aux[4],
                   intv=aux[5], max_r_walk=aux[6])


def _pack4(vals: np.ndarray) -> np.ndarray:
    """uint8 symbols (< 16) -> uint32 words, 8 per word, little-endian."""
    n = len(vals)
    W = (n + 7) // 8 + 1
    padded = np.zeros(W * 8, dtype=np.uint32)
    padded[:n] = vals
    words = np.zeros(W, dtype=np.uint32)
    for j in range(8):
        words |= padded[j::8] << np.uint32(4 * j)
    return words


def build_sampled_sa(idx: SaltIndex, intv: int = 8) -> SampledSA:
    n1 = len(idx.csa)            # n + 1 ranks
    csa_true = idx.csa.astype(np.int64).copy()
    csa_true[0] = n1 - 1         # undo the sa[0] = 0xFFFFFFFF quirk
    mask = (csa_true % intv) == 0
    # fused select: excl count at each 32-rank word + the bit word
    W = (n1 + 31) // 32 + 1
    bits = np.zeros(W, dtype=np.uint32)
    ranks = np.nonzero(mask)[0]
    np.bitwise_or.at(bits, ranks >> 5, np.uint32(1) << (ranks & 31).astype(np.uint32))
    per_word = np.bincount(ranks >> 5, minlength=W)
    c_sel = np.zeros((W, 2), dtype=np.int32)
    c_sel[1:, 0] = np.cumsum(per_word)[:-1]
    c_sel[:, 1] = bits.view(np.int32)
    # stored value keeps the rank-0 quirk byte-for-byte
    c_samples = idx.csa[mask]

    # R: '#' ranks are [cumfreq[4]+1, cumfreq[5]+1) in in-band-sentinel
    # rank coords (the sentinel suffix is rank 0)
    sharp_lo = int(idx.r_cumfreq[4]) + 1
    sharp_hi = int(idx.r_cumfreq[5]) + 1
    if (idx.sharp_bases is not None
            and sharp_hi - sharp_lo != len(idx.sharp_bases)):
        # a legacy bundle of a SNP-bearing index saved with zeros(0)
        # would otherwise load as "valid zero-SNP" and silently blank
        # every R coordinate (advisor r4 finding)
        raise ValueError(
            f"inconsistent index bundle: {sharp_hi - sharp_lo} '#' ranks "
            f"in the R BWT but {len(idx.sharp_bases)} sharp_bases entries")
    if idx.sharp_bases is None:
        raise ValueError("index missing sharp_bases; rebuild with current "
                         "version for sa_mode='sampled'")
    # R select structure: a walk may stop at a '#' rank (value =
    # sharp_base: coord(p) = base + steps, rbwt.c:316-333 semantics) or
    # at any rank whose coordinate is a multiple of intv (value = that
    # coordinate; coordinates are affine in text position within a
    # segment, so r_coord[k0] = value + steps there too).  Both are
    # derivable from the bundle's r_coord — no index-build changes —
    # and together they bound every R walk at intv-1 steps.
    n1r = len(idx.r_coord)
    rmask = np.zeros(n1r, dtype=bool)
    rc = idx.r_coord
    rmask[(rc != np.uint32(UINT32_MAX)) & (rc % np.uint32(intv) == 0)] = True
    rmask[sharp_lo:sharp_hi] = True
    rvals = rc.copy()
    if sharp_hi > sharp_lo:
        rvals[sharp_lo:sharp_hi] = idx.sharp_bases
    Wr = (n1r + 31) // 32 + 1
    rranks = np.nonzero(rmask)[0]
    rbits = np.zeros(Wr, dtype=np.uint32)
    np.bitwise_or.at(rbits, rranks >> 5,
                     np.uint32(1) << (rranks & 31).astype(np.uint32))
    r_per_word = np.bincount(rranks >> 5, minlength=Wr)
    r_sel = np.zeros((Wr, 2), dtype=np.int32)
    r_sel[1:, 0] = np.cumsum(r_per_word)[:-1]
    r_sel[:, 1] = rbits.view(np.int32)
    r_samples = rvals[rmask]
    if len(r_samples) == 0:
        # zero-SNP index: no local patterns at all; keep one dummy slot
        # so gathers stay in-bounds (no R lane is ever active)
        r_samples = np.array([0x80000000], dtype=np.uint32)
    c_words_arr = _pack4(idx.cbwt)
    r_words_arr = _pack4(idx.rbwt)
    return SampledSA(
        sel_cat=jnp.asarray(np.concatenate([c_sel, r_sel])),
        samples_cat=jnp.asarray(np.concatenate([c_samples, r_samples])),
        syms_cat=jnp.asarray(np.concatenate([c_words_arr, r_words_arr])),
        c_words=len(c_words_arr),
        c_sel_rows=W,
        c_n_samples=len(c_samples),
        sharp_lo=sharp_lo,
        sharp_hi=sharp_hi,
        intv=intv,
        max_r_walk=intv,
    )


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("k",))
def _device_lkt(pac: jnp.ndarray, k: int = 12) -> jnp.ndarray:
    """Device-side build of the C-part 12-mer prefix-sum table,
    bit-identical to index.build.build_lookup_table (incl. the A-padded
    tail quirk, LookUpTable.c:114-135).  Transfers n bytes of pac codes
    instead of the 67MB table."""
    n = pac.shape[0]
    n_item = (1 << (2 * k)) + 1
    n_win = n - k + 1
    p = pac.astype(jnp.uint32)
    kmers = jnp.zeros((n_win,), jnp.uint32)
    for j in range(k):
        kmers = (kmers << 2) + jax.lax.dynamic_slice(p, (j,), (n_win,))
    counts = jnp.zeros((n_item,), jnp.uint32)
    counts = counts.at[kmers.astype(jnp.int32) + 1].add(jnp.uint32(1),
                                                        mode="drop")
    # tail: shift in zeros k times from the last full window
    mask = jnp.uint32(n_item - 2)
    it = kmers[-1]
    for _ in range(k):
        it = (it << 2) & mask
        counts = counts.at[it.astype(jnp.int32) + 1].add(jnp.uint32(1),
                                                         mode="drop")
    return jnp.cumsum(counts, dtype=jnp.uint32)


@_partial(jax.jit, static_argnames=("k", "chunk"))
def _device_r_lkt(ri_r: RankIndex, k: int = 12, chunk: int = 1 << 21):
    """Device-side build of the exact R-part 12-mer interval tables by
    running the 12 backward-search LF steps for every k-mer from the
    full interval — the construction the table replaces, so seeding is
    result-identical (ops/seed.py uses only sp, ep and the sp<=ep
    liveness; dead kmers store the canonical empty interval (1, 0))."""
    n_kmer = 1 << (2 * k)
    from ..ops.rank import lf_step

    def build_chunk(base):
        kmer = base + jnp.arange(chunk, dtype=jnp.int32)
        kk = jnp.zeros((chunk,), jnp.int32)
        ll = jnp.full((chunk,), ri_r.n, jnp.int32)
        alive = jnp.ones((chunk,), bool)
        for j in range(k):       # last char first (backward search)
            c = (kmer >> (2 * j)) & 3
            kn, ln = lf_step(ri_r, kk, ll, c)
            new_alive = alive & ~(kn > ln)
            kk = jnp.where(new_alive, kn, kk)
            ll = jnp.where(new_alive, ln, ll)
            alive = new_alive
        sp = jnp.where(alive, kk, 1).astype(jnp.uint32)
        ep = jnp.where(alive, ll, 0).astype(jnp.uint32)
        return sp, ep

    bases = jnp.arange(0, n_kmer, chunk, dtype=jnp.int32)
    sp, ep = jax.lax.map(build_chunk, bases)   # (n_chunks, chunk) each
    return sp.reshape(-1), ep.reshape(-1)


# genomes below this length build the C lkt on device from pac codes
# (n bytes) instead of transferring the 67MB host table; above it the
# table transfer is the smaller payload
_DEVICE_LKT_MAX = int(os.environ.get("SALT_TPU_DEVICE_LKT_MAX", str(1 << 26)))

# texts below this many ranks derive the full locate tables (csa +
# r_coord, the dominant transfer bytes) on device from the sampled-SA
# structures via bounded LF walks; above it the one-time walk cost
# outweighs the transfer saving
_DERIVE_SA_MAX = int(os.environ.get("SALT_TPU_DERIVE_SA_MAX", str(1 << 25)))


@_partial(jax.jit, static_argnames=("n1c", "n1r", "n_sharp"))
def _derive_sa_cat(sampled: "SampledSA", ri_c: RankIndex, ri_r: RankIndex,
                   n1c: int, n1r: int, n_sharp: int) -> jnp.ndarray:
    """Derive the full-table sa_cat (csa ++ r_coord) on device by
    resolving every rank through the sampled-SA walk (ops/locate.py
    resolve_sampled) — the walk reproduces the full-table values for
    every rank reachable as a locate candidate, so the one-gather
    "full" locate path keeps its speed while only the ~30x smaller
    sampled structures are transferred."""
    from ..ops.locate import resolve_sampled

    kc = jnp.arange(n1c, dtype=jnp.int32)
    csa = resolve_sampled(sampled, ri_c, ri_r, kc,
                          jnp.zeros((n1c,), bool), jnp.ones((n1c,), bool))
    if n_sharp == 0:
        # zero-SNP index: no segments -> pos2coord is all UINT32_MAX, so
        # every r_coord entry is UINT32_MAX (index/build.py:450,480) —
        # no walk needed (and the R walk has no '#' anchors to stop at)
        rco = jnp.full((n1r,), 0xFFFFFFFF, jnp.uint32)
    else:
        kr = jnp.arange(n1r, dtype=jnp.int32)
        rco = resolve_sampled(sampled, ri_c, ri_r, kr,
                              jnp.ones((n1r,), bool), jnp.ones((n1r,), bool))
    return jnp.concatenate([csa, rco])


def to_device_index(idx: SaltIndex, sa_mode: str = "full",
                    sa_intv: int = 8):
    """sa_mode="full": one-gather locate (fastest, 4B/rank HBM).
    sa_mode="sampled": bounded LF-walk locate at ~n/3 bytes total —
    whole-human-genome indexes fit a single chip.  Returns DeviceIndex
    or (DeviceIndex, SampledSA)."""
    from ..ops.rank import build_rank_index_device

    n1c = len(idx.csa)
    n1r = len(idx.r_coord)
    # gate on BOTH rank counts: _derive_sa_cat LF-walks all n1c C ranks
    # too, and a large genome with a small SNP overlay would otherwise
    # pay an enormous device walk (advisor finding, round 3)
    small = (max(n1c, n1r) <= _DERIVE_SA_MAX
             and idx.sharp_bases is not None)
    # both paths produce FUSED rank indexes: one concatenated plane
    # array shared by the C and R views (RankIndex.row_off), so the
    # sampled-SA locate walk pays one rank gather per step instead of
    # one per family — same HBM, one buffer
    if small:
        # transfer-lean load: ship the 4-bit packed BWTs (n/2 bytes) and
        # build the rank planes on device
        from ..ops.rank import fuse_rank_index_pair

        ri_c = build_rank_index_device(
            jnp.asarray(_pack4(idx.cbwt)), len(idx.cbwt), 5,
            np.append(idx.c_l2, 0))
        ri_r = build_rank_index_device(
            jnp.asarray(_pack4(idx.rbwt)), len(idx.rbwt), 6,
            np.append(idx.r_cumfreq, 0))
        ri_c, ri_r = fuse_rank_index_pair(ri_c, ri_r)
    else:
        # big indexes (up to whole-genome): still ship only the packed
        # syms (n/2 bytes) and build planes on device, chunked so the
        # transient stays bounded — host-built planes would triple the
        # transfer (~1.5n bytes).  Built fused in one jit: each plane
        # lands in its slice of the one cat buffer.
        from ..ops.rank import build_rank_index_pair_device_chunked

        ri_c, ri_r = build_rank_index_pair_device_chunked(
            jnp.asarray(_pack4(idx.cbwt)), len(idx.cbwt), 5,
            np.append(idx.c_l2, 0),
            jnp.asarray(_pack4(idx.rbwt)), len(idx.rbwt), 6,
            np.append(idx.r_cumfreq, 0))
    if idx.r_lkt_sp is None:
        raise ValueError("index missing r_lkt tables; rebuild with current version")
    if sa_mode == "sampled":
        sampled = build_sampled_sa(idx, sa_intv)
        sa_cat = jnp.zeros((2,), jnp.uint32)  # placeholder, unused
        c_sa_len = 1
    else:
        sampled = None
        if small:
            sam = build_sampled_sa(idx, sa_intv)
            sa_cat = _derive_sa_cat(sam, ri_c, ri_r, n1c=n1c, n1r=n1r,
                                    n_sharp=len(idx.sharp_bases))
        else:
            sa_cat = jnp.asarray(np.concatenate([idx.csa, idx.r_coord]))
        c_sa_len = n1c
    if idx.l_pac <= _DEVICE_LKT_MAX:
        lkt = _device_lkt(jnp.asarray(idx.pac), k=12)
        r_lkt_sp, r_lkt_ep = _device_r_lkt(ri_r, k=12)
    else:
        lkt = jnp.asarray(idx.lkt)
        r_lkt_sp = jnp.asarray(idx.r_lkt_sp)
        r_lkt_ep = jnp.asarray(idx.r_lkt_ep)
    dix = DeviceIndex(
        ri_c=ri_c,
        ri_r=ri_r,
        lkt=lkt,
        r_lkt_sp=r_lkt_sp,
        r_lkt_ep=r_lkt_ep,
        sa_cat=sa_cat,
        mixref_words=jnp.asarray(pack_nibbles(idx.mixref)),
        l_pac=idx.l_pac,
        l_seed=idx.l_seed,
        c_sa_len=c_sa_len,
    )
    if sa_mode == "sampled":
        return dix, sampled
    return dix
