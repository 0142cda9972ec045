"""Batched candidate location (alnse_locate_alt, Align_src/alnse.c:633-731).

The reference LF-walks every SA rank to a sampled checkpoint (bwt_sa,
bwt.c:89-102) or to a '#' anchor (rbwt.c:316-333).  We instead store the
full SA / coordinate tables so each locate is one gather; the sequential
per-strand cap (`max_locate` pushes, where only in-range positions count
as pushes) is reproduced with prefix sums over a fixed slot capacity.

Ordering matches the reference: C seeds first, then R seeds, each group
sorted ascending by interval width (ks_introsort_sai, alnse.c:307-308 —
we sort stably; the reference's introsort may reorder equal widths,
which can matter only when the locate cap truncates).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import MAX_LOC_POS, UINT32_MAX
from .seed import Seeds


class Loci(NamedTuple):
    pos: jnp.ndarray      # uint32 (B, CAP) candidate positions
    pushed: jnp.ndarray   # bool   (B, CAP) slot holds a pushed locus


class LocateOut(NamedTuple):
    loci: "Loci"
    overflow: jnp.ndarray  # bool (B,) candidate stream exceeded CAP slots


def _get4(words: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """4-bit packed symbol at index k (8 per uint32 word).  k is a rank
    carried in int32, possibly wrapped for whole-genome texts — shift
    through uint32 (word index < 2^29 fits int32 again)."""
    ku = k.astype(jnp.uint32)
    w = words[jnp.clip((ku >> 3).astype(jnp.int32), 0, words.shape[0] - 1)]
    return ((w.astype(jnp.uint32) >> ((ku & 7) * 4)) & 15).astype(jnp.int32)


def resolve_sampled(sampled, ri_c, ri_r, rank, is_r, active):
    """Rank -> coordinate via bounded LF walks against the sampled-SA
    tables (pipeline/device_index.SampledSA): both families walk to a
    flagged stop rank within intv-1 steps (C: text-position-sampled;
    R: '#' anchors + coordinate-sampled).  Exactly reproduces the
    full-table values, including the csa[0] quirk and UINT32_MAX at
    '#' positions.

    The C and R select/symbol/value tables are concatenated, so each
    iteration pays ONE fused gather per structure with a per-lane
    family offset.  When the rank indexes share one concatenated plane
    array (RankIndex.row_off — to_device_index builds them that way,
    no HBM duplication), the rank query is also a single per-lane
    family-offset gather; standalone indexes fall back to one rank
    gather per family."""
    from .rank import rank_excl, umin

    s = sampled
    n1c = ri_c.n
    n1r = ri_r.n
    # rank values are carried in int32 and may be WRAPPED for
    # whole-genome C texts (n1c >= 2^31); every comparison/clip/shift on
    # them goes through uint32.  Bounds as uint32 scalars (a python int
    # >= 2^31 cannot become an int32 literal).
    bound = jnp.where(is_r, jnp.uint32(n1r - 1), jnp.uint32(n1c - 1))
    woff = jnp.where(is_r, jnp.int32(s.c_words), jnp.int32(0))
    seloff = jnp.where(is_r, jnp.int32(s.c_sel_rows), jnp.int32(0))
    sampoff = jnp.where(is_r, jnp.int32(s.c_n_samples), jnp.int32(0))

    def sel_row(k):
        w = (k.astype(jnp.uint32) >> 5).astype(jnp.int32) + seloff
        return s.sel_cat[jnp.clip(w, 0, s.sel_cat.shape[0] - 1)]

    def is_done(k):
        row = sel_row(k)
        bit = (row[..., 1].astype(jnp.uint32)
               >> (k.astype(jnp.uint32) & 31)) & 1
        return bit == 1

    k0 = umin(rank, bound)
    done0 = ~active | is_done(k0)
    steps0 = jnp.zeros_like(k0)

    # hard trip bound: guarantees termination even on degenerate lanes
    # (e.g. a zero-SNP index has no R stop ranks at all)
    max_steps = max(int(s.intv), int(s.max_r_walk)) + 1

    def cond(st):
        return jnp.any(~st[2]) & (st[1].max() < max_steps)

    # the two rank indexes share one concatenated plane array iff
    # to_device_index fused them (static shapes/offsets -> trace-time
    # branch); then the walk's rank query is ONE per-lane gather
    fused_planes = (
        ri_c.row_off == 0
        and ri_r.row_off == 5 * ri_c.n_words
        and ri_c.bc.shape[0] == 5 * ri_c.n_words + 6 * ri_r.n_words
        and ri_r.bc.shape[0] == ri_c.bc.shape[0]
    )

    def body(st):
        k, steps, done = st
        ku = k.astype(jnp.uint32)
        w = jnp.clip((ku >> 3).astype(jnp.int32) + woff, 0,
                     s.syms_cat.shape[0] - 1)
        word = s.syms_cat[w].astype(jnp.uint32)
        sym = ((word >> ((ku & 7) * 4)) & 15).astype(jnp.int32)
        if fused_planes:
            # single fused rank gather: per-lane (family, symbol, word)
            # row into the shared plane array.  Arithmetic matches the
            # per-family rank_excl calls below bit-for-bit.
            symc = jnp.clip(sym, 0, 4)
            symr = jnp.clip(sym, 0, 5)
            iu = jnp.where(is_r, umin(k, jnp.uint32(n1r)),
                           umin(k, jnp.uint32(n1c))).astype(jnp.uint32)
            wi = (iu >> 5).astype(jnp.int32)
            rbit = iu & 31
            row_idx = jnp.where(
                is_r, jnp.int32(ri_r.row_off) + symr * ri_r.n_words,
                symc * ri_c.n_words) + wi
            row2 = ri_c.bc[row_idx]
            word2 = row2[..., 1].astype(jnp.uint32)
            m2 = jnp.where(rbit > 0,
                           (jnp.uint32(1) << rbit) - jnp.uint32(1),
                           jnp.uint32(0))
            cnt = row2[..., 0] + jax.lax.population_count(
                word2 & m2).astype(jnp.int32)
            base = jnp.where(is_r, ri_r.cfreq[jnp.clip(sym, 0, 6)],
                             ri_c.cfreq[jnp.clip(sym, 0, 5)])
            kn = umin(base + cnt + 1, bound)
        else:
            kc = ri_c.cfreq[jnp.clip(sym, 0, 5)] + rank_excl(
                ri_c, umin(k, jnp.uint32(n1c)), jnp.clip(sym, 0, 4)) + 1
            kr = ri_r.cfreq[jnp.clip(sym, 0, 6)] + rank_excl(
                ri_r, umin(k, jnp.uint32(n1r)), jnp.clip(sym, 0, 5)) + 1
            kn = umin(jnp.where(is_r, kr, kc), bound)
        k = jnp.where(done, k, kn)
        steps = steps + (~done).astype(jnp.int32)
        done = done | is_done(k)
        return k, steps, done

    k, steps, _ = jax.lax.while_loop(cond, body, (k0, steps0, done0))

    row = sel_row(k)
    kl = k.astype(jnp.uint32) & 31
    mask = jnp.where(kl > 0, (jnp.uint32(1) << kl) - jnp.uint32(1),
                     jnp.uint32(0))
    slot = row[..., 0] + jax.lax.population_count(
        row[..., 1].astype(jnp.uint32) & mask).astype(jnp.int32) + sampoff
    val = s.samples_cat[jnp.clip(slot, 0, s.samples_cat.shape[0] - 1)]
    on_sharp = (k >= s.sharp_lo) & (k < s.sharp_hi)
    return jnp.where(
        is_r & (steps == 0) & on_sharp,
        jnp.uint32(UINT32_MAX),  # candidate ON a '#': full table says so
        val + steps.astype(jnp.uint32),
    )


def locate(
    c_seeds: Seeds,
    r_seeds: Seeds,
    sa_cat: jnp.ndarray,    # uint32 [c_sa_len + Tr+1]: csa ++ r_coord
    c_sa_len: int,
    l_seq,                  # int32 () or scalar: read length
    l_mref: int,
    max_locate: int,
    cap: int,
    pe_mode: bool = False,
    sampled=None,           # SampledSA: LF-walk locate instead of sa_cat
    ri_c=None,
    ri_r=None,
    chunk=None,             # column block size for in-range-only slot
                            # processing; None -> $SALT_TPU_LOCATE_CHUNK
                            # (default 128) at trace time; <=0 -> flat
) -> Loci:
    """Returns located candidate positions per read, sorted ascending.

    SE flavor (alnse_locate_alt, pe_mode=False), uint32 arithmetic:
      C locus pushed  iff  uint32(pos + l_seq) <= l_mref          (:673)
      R locus pushed  iff  pos <= l_mref and uint32(pos+l_seq) <= l_mref  (:717)
    and pushes stop after `max_locate` of them (:678,:719).

    PE flavor (alnse_locate, pe_mode=True, alnse.c:501-629): each C seed
    is capped at max_locate ranks on its own (:523), R seeds wider than
    max_locate are subsampled (the reference uses rand() there — we use a
    deterministic stride, the only intended divergence), and the global
    cap is MAX_LOC_POS.
    """
    B, S = c_seeds.sp.shape

    def fam(seeds: Seeds, is_r: bool):
        # ep - sp is mod-2^32 exact; the signed clamp at 2^28-1 keeps
        # count/cum arithmetic inside int32 for whole-genome-scale
        # intervals (a seed with >2^28 candidates saturates the slot
        # capacity regardless, so the clamp never changes which loci
        # are materialized) while preserving the negative-width "empty
        # interval" semantics (sp = ep + 1 -> width -1 -> zero count).
        # A true width >= 2^31 (one seed interval covering half the
        # text) wraps negative and yields no candidates — accepted:
        # such a seed is pure repeat noise and the reference would
        # spend hours walking it.
        width = jnp.minimum(seeds.ep - seeds.sp, jnp.int32(2**28 - 1))
        if pe_mode:
            if is_r:
                n_skip = jnp.where(width > max_locate,
                                   jnp.maximum(width // max_locate, 1), 1)
                count = jnp.where(seeds.valid, width // n_skip + 1, 0)
            else:
                n_skip = jnp.ones_like(width)
                count = jnp.where(
                    seeds.valid, jnp.minimum(width + 1, max_locate), 0
                )
        else:
            count = jnp.where(seeds.valid, width + 1, 0)
            if is_r:
                n_skip = jnp.maximum((width + 1) // MAX_LOC_POS, 1)
                count = jnp.where(seeds.valid, width // n_skip + 1, 0)
            else:
                n_skip = jnp.ones_like(width)
        # sort key: valid C widths < valid R widths < invalid.  Widths are
        # clamped to 2^28-1 for the key only — wider (garbage) intervals
        # order as equal, which the reference's non-stable introsort
        # doesn't define any better (alnse.c:307).
        key = jnp.where(
            seeds.valid,
            jnp.minimum(width, jnp.int32(2**28 - 1))
            + (jnp.int32(2**28) if is_r else jnp.int32(0)),
            jnp.int32(2**29) + (jnp.int32(2**28) if is_r else jnp.int32(0)),
        )
        return key, count, n_skip

    key_c, cnt_c, skip_c = fam(c_seeds, False)
    key_r, cnt_r, skip_r = fam(r_seeds, True)

    # one stable multi-operand sort orders the concatenated C-then-R seed
    # stream by (family, width) — replaces two argsorts + eight gathers
    key2 = jnp.concatenate([key_c, key_r], axis=-1)      # (B, 2S)
    sp2 = jnp.concatenate([c_seeds.sp, r_seeds.sp], axis=-1)
    off2 = jnp.concatenate([c_seeds.offset, r_seeds.offset], axis=-1)
    cnt2 = jnp.concatenate([cnt_c, cnt_r], axis=-1)
    skip2 = jnp.concatenate([skip_c, skip_r], axis=-1)
    key_s, sp, off, cnt, skip = jax.lax.sort(
        [key2, sp2, off2, cnt2, skip2], dimension=1, num_keys=1,
        is_stable=True,
    )
    is_r = (key_s & jnp.int32(2**28)) != 0

    # per-seed counts are clamped at cap+1 before the prefix sum so
    # `cum`/`total` stay inside int32 for any seed set (2S * (cap+1)
    # << 2^31; unclamped, 2S seeds of 2^28 candidates each would wrap
    # and silently zero the read's candidates).  Equivalent for every
    # materialized slot t < cap: a seed owns t iff cum_ex <= t < cum,
    # and clamping only moves cum values that are already > cap — it
    # never changes ownership of, or the rank within, a slot below cap,
    # and (total > cap), the overflow predicate, is preserved.
    cnt = jnp.minimum(cnt, jnp.int32(cap + 1))
    cum = jnp.cumsum(cnt, axis=-1)                        # inclusive
    total = cum[:, -1]
    cum_ex = cum - cnt                                    # exclusive

    # fused per-seed attribute gather: one 2-wide row gather.  rank =
    # sp + (slot - cum_ex) * skip is refactored to fused + slot * skip
    # (int32 wraparound in the intermediate is harmless — the final rank
    # is in range, and XLA int arithmetic is two's-complement).  skip
    # and (offset, is_r) share the second word: skip is clamped to 19
    # bits (only reachable by the PE R-subsample stride, where the
    # stride is already an intended deterministic divergence) and
    # offset < 2^11 (seed start within the read; read length <= 2047).
    skip = jnp.minimum(skip, jnp.int32(2**19 - 1))
    fused = sp - cum_ex * skip
    packed = (skip << 12) | (off << 1) | is_r.astype(jnp.int32)
    attrs = jnp.stack([fused, packed], axis=-1)           # (B, 2S, 2)

    def slot_block(slots):
        """Per-slot candidate materialization for a column block.

        slot t -> seed index: the covering seed is the first one whose
        inclusive cumsum exceeds t, i.e. seed_idx = #{j : cum[j] <= t}
        (searchsorted side="right").  Computed as an all-compare
        reduction — pure broadcast compare + sum, which XLA fuses
        without materializing (B, |slots|, 2S).  Zero-count seeds
        share their predecessor's cum value and are skipped for free.
        Returns (pos, valid_push) for the block."""
        seed_idx = jnp.sum(
            cum[:, None, :] <= slots[None, :, None], axis=-1,
            dtype=jnp.int32,
        )                                                 # (B, |slots|)
        in_range = (slots[None, :] < total[:, None]) & (slots[None, :] < cap)
        rows = jnp.take_along_axis(
            attrs, jnp.clip(seed_idx, 0, 2 * S - 1)[..., None], axis=1
        )                                                 # (B, |slots|, 2)
        rank = rows[..., 0] + slots[None, :] * (rows[..., 1] >> 12)
        slot_is_r = (rows[..., 1] & 1).astype(bool)
        offset = (rows[..., 1] >> 1) & jnp.int32(0x7FF)

        if sampled is not None:
            sa_val = resolve_sampled(sampled, ri_c, ri_r, rank, slot_is_r,
                                     in_range)
        else:
            rank_c = jnp.clip(rank, 0, c_sa_len - 1)
            rank_r = (jnp.clip(rank, 0, sa_cat.shape[0] - c_sa_len - 1)
                      + c_sa_len)
            sa_val = sa_cat[jnp.where(slot_is_r, rank_r, rank_c)]
        pos = (sa_val.astype(jnp.uint32) - offset.astype(jnp.uint32))

        end_u = pos + jnp.uint32(l_seq)  # uint32 wraparound, as in C
        ok_c = end_u <= jnp.uint32(l_mref)
        ok_r = (pos <= jnp.uint32(l_mref)) & ok_c
        valid_push = in_range & jnp.where(slot_is_r, ok_r, ok_c)
        return pos, valid_push

    push_cap = MAX_LOC_POS if pe_mode else max_locate
    if chunk is None:
        import os as _os
        # default: chunked only in sampled mode, where per-slot cost is
        # the bounded LF walk (~40 HBM gathers/slot) and skipping empty
        # columns is a large win.  In full mode the per-slot cost is one
        # fused all-compare + one gather — a single large fused kernel
        # that the while_loop's serialized iterations would only slow.
        dflt = "128" if sampled is not None else "0"
        chunk = int(_os.environ.get("SALT_TPU_LOCATE_CHUNK", dflt))
    if chunk <= 0 or cap <= chunk:
        # flat path: every slot in one block
        slots = jnp.arange(cap, dtype=jnp.int32)
        pos, valid_push = slot_block(slots)
        n_before = jnp.cumsum(valid_push.astype(jnp.int32), axis=-1)
        pushed = valid_push & (n_before <= push_cap)
        n_push_final = n_before[:, -1]
    else:
        # chunked path: per-slot work (the all-compare seed mapping and,
        # in sampled mode, the LF-walk resolution — the whole-genome hot
        # spot) only runs for column blocks that contain in-range slots.
        # Active slots are a PREFIX of each row (in_range = slot <
        # total), so a while_loop over column blocks bounded by the
        # batch max total covers exactly the live work; untouched slots
        # keep (pos=~0, pushed=False), which downstream treats as
        # not-pushed (sort_loci keys un-pushed slots 0xFFFFFFFF anyway).
        CH = chunk
        n_ch = (cap + CH - 1) // CH
        pad_cap = n_ch * CH
        need = jnp.minimum(jnp.max(total), jnp.int32(cap))
        n_ch_dyn = (need + CH - 1) // CH

        def cond(st):
            return st[0] < n_ch_dyn

        def body(st):
            j, pos_buf, push_buf, nb_run = st
            slots = j * CH + jnp.arange(CH, dtype=jnp.int32)
            pos, valid_push = slot_block(slots)
            nb = nb_run[:, None] + jnp.cumsum(
                valid_push.astype(jnp.int32), axis=-1)
            pushed = valid_push & (nb <= push_cap)
            pos_buf = jax.lax.dynamic_update_slice(pos_buf, pos, (0, j * CH))
            push_buf = jax.lax.dynamic_update_slice(
                push_buf, pushed, (0, j * CH))
            return j + 1, pos_buf, push_buf, nb[:, -1]

        j0 = jnp.int32(0)
        pos_buf = jnp.full((B, pad_cap), UINT32_MAX, dtype=jnp.uint32)
        push_buf = jnp.zeros((B, pad_cap), dtype=bool)
        nb0 = jnp.zeros((B,), dtype=jnp.int32)
        _, pos_buf, push_buf, n_push_final = jax.lax.while_loop(
            cond, body, (j0, pos_buf, push_buf, nb0))
        pos = pos_buf[:, :cap]
        pushed = push_buf[:, :cap]

    # overflow: the candidate stream exceeded CAP slots AND the push cap
    # was not yet reached — only then could unmaterialized candidates
    # have produced additional pushes (pushes stop at push_cap anyway,
    # alnse.c:678, so a read that filled its cap is already exact).
    overflow = (total > cap) & (n_push_final < push_cap)
    return LocateOut(loci=Loci(pos=pos, pushed=pushed), overflow=overflow)


def sort_loci(loci: Loci) -> Loci:
    """Sort pushed loci ascending per read (ks_introsort, alnse.c:728).

    Un-pushed slots are keyed 0xFFFFFFFF, and `pushed` is re-derived from
    the sorted key — a single-operand sort.  A genuinely pushed position
    of exactly 0xFFFFFFFF (wraparound pos == -1) is conflated with the
    sentinel, which is harmless: such a candidate fails the in-range
    check in the ungapped path and the in-ref mask in the gapped path
    either way, contributing nothing downstream."""
    key = jnp.where(loci.pushed, loci.pos, jnp.uint32(0xFFFFFFFF))
    (key_sorted,) = jax.lax.sort([key], dimension=1, num_keys=1)
    return Loci(pos=key_sorted, pushed=key_sorted != jnp.uint32(0xFFFFFFFF))
