"""Single-end alignment pipeline: batched device steps.

Mirrors alnse_overlap_alt (Align_src/alnse.c:1045-1104): seed both
strands, locate, ungapped check with the shrinking threshold, and — only
for reads with no ungapped hit on either strand — the gapped
Landau-Vishkin check (alnse_check_withgap, alnse.c:871-901).

For throughput, verification is compacted to the first `u` unique
in-range candidates per read (enough for essentially all reads; the
few reads with more flow through a full-width fallback so the result is
still reference-exact).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import GAP_WINDOW_PAD, NOGAP_MAX_DIFF, UINT32_MAX
from ..ops.locate import Loci, locate, sort_loci
from ..ops.lv import lv_distance_batch
from ..ops.seed import seed_overlap
from ..ops.verify import (
    SEResult,
    StrandVerify,
    checked_mask,
    compact_loci,
    mismatch_counts_packed,
    replay_and_select,
)
from .device_index import DeviceIndex

class UngappedOut(NamedTuple):
    res: SEResult
    needs_gap: jnp.ndarray   # bool (B,)
    overflow: jnp.ndarray    # bool (B,) verify or locate truncated; the
                             # engine re-runs such reads at full width
    loci0: Loci
    loci1: Loci


def pack_result(res: SEResult, extra=None) -> jnp.ndarray:
    """Flatten an SEResult (+ optional (B,) extra flags) into one int32
    matrix so the host needs a single device->host transfer.
    Layout: [found, pos, strand, n_diff, n_hits(2), first_hit_ndiff(2),
    hits_pos(2K), hits_ndiff(2K), extras...]."""
    B = res.found.shape[0]
    K = res.hits_pos.shape[-1]
    cols = [
        res.found.astype(jnp.int32)[:, None],
        res.pos.astype(jnp.int32)[:, None],     # bit-pattern preserved
        res.strand[:, None],
        res.n_diff[:, None],
        res.n_hits.reshape(B, 2),
        res.first_hit_ndiff.reshape(B, 2),
        res.hits_pos.astype(jnp.int32).reshape(B, 2 * K),
        res.hits_ndiff.reshape(B, 2 * K),
    ]
    if extra is not None:
        cols.extend(e.astype(jnp.int32)[:, None] for e in extra)
    return jnp.concatenate(cols, axis=1)


def unpack_result(arr, k_hits: int):
    """numpy view of a pack_result matrix -> dict of arrays."""
    import numpy as np

    K = k_hits
    B = arr.shape[0]
    out = {
        "found": arr[:, 0].astype(bool),
        "pos": arr[:, 1].astype(np.uint32),
        "strand": arr[:, 2],
        "n_diff": arr[:, 3],
        "n_hits": arr[:, 4:6],
        "first_hit_ndiff": arr[:, 6:8],
        "hits_pos": arr[:, 8 : 8 + 2 * K].reshape(B, 2, K).astype(np.uint32),
        "hits_ndiff": arr[:, 8 + 2 * K : 8 + 4 * K].reshape(B, 2, K),
    }
    out["n_extra"] = arr[:, 8 + 4 * K :]
    return out


def _seed_and_locate(dix: DeviceIndex, seq, l_overlap, max_seed, max_locate,
                     cap, pe_mode=False, sampled=None, chunk=None):
    L = seq.shape[-1]
    c_seeds, r_seeds = seed_overlap(
        dix.ri_c, dix.ri_r, dix.lkt, seq, dix.l_seed, l_overlap, max_seed,
        r_lkt_sp=dix.r_lkt_sp, r_lkt_ep=dix.r_lkt_ep,
    )
    lo = locate(
        c_seeds, r_seeds, dix.sa_cat, dix.c_sa_len, L, dix.l_pac,
        max_locate, cap, pe_mode=pe_mode, sampled=sampled,
        ri_c=dix.ri_c, ri_r=dix.ri_r, chunk=chunk,
    )
    return sort_loci(lo.loci), lo.overflow


@partial(jax.jit, static_argnames=(
    "l_overlap", "max_seed", "max_locate", "cap", "pe_mode", "chunk"))
def _se_seed_locate(
    dix: DeviceIndex,
    seq_f: jnp.ndarray,
    seq_r: jnp.ndarray,
    l_overlap: int,
    max_seed: int,
    max_locate: int,
    cap: int,
    pe_mode: bool = False,
    sampled=None,
    chunk: int = None,
):
    """Phase 1: seed + locate + sort, both strands in one (2B,...) batch."""
    # reads arrive as uint8 (transfer-lean); compute in int32
    seq2 = jnp.concatenate([seq_f, seq_r], axis=0).astype(jnp.int32)
    lc, loc_ovf = _seed_and_locate(dix, seq2, l_overlap, max_seed,
                                   max_locate, cap, pe_mode, sampled, chunk)
    return seq2, lc, loc_ovf


@partial(jax.jit, static_argnames=("u",))
def _se_verify(
    dix: DeviceIndex,
    seq2: jnp.ndarray,
    lc: Loci,
    loc_ovf: jnp.ndarray,
    u: int,
):
    """Phase 2: compact + word-packed mismatch counts."""
    chk = checked_mask(lc, dix.l_pac)
    pos, keep, ovf = compact_loci(lc, chk, u)
    ovf = ovf | loc_ovf
    v = mismatch_counts_packed(
        dix.mixref_words, pos, keep, seq2, NOGAP_MAX_DIFF + 1
    )
    return v, ovf


@partial(jax.jit, static_argnames=("k_hits",))
def _se_select(
    v: StrandVerify,
    ovf: jnp.ndarray,
    lc: Loci,
    k_hits: int,
) -> UngappedOut:
    """Phase 3: threshold replay + primary/hit-list selection."""
    B = v.counts.shape[0] // 2
    half = lambda a: (a[:B], a[B:])
    v0, v1 = (StrandVerify(*z) for z in zip(*map(half, v)))
    loci0, loci1 = (Loci(*z) for z in zip(*map(half, lc)))
    ovf0, ovf1 = half(ovf)
    res = replay_and_select(v0, v1, NOGAP_MAX_DIFF, k_hits)
    return UngappedOut(
        res=res,
        needs_gap=~res.found,
        overflow=ovf0 | ovf1,
        loci0=loci0,
        loci1=loci1,
    )


def se_ungapped(
    dix: DeviceIndex,
    seq_f: jnp.ndarray,     # (B, L) forward codes
    seq_r: jnp.ndarray,     # (B, L) reverse-complement codes
    l_overlap: int,
    max_seed: int,
    max_locate: int,
    cap: int,
    u: int = 64,
    k_hits: int = 16,
    pe_mode: bool = False,
    sampled=None,
    chunk: int = None,   # locate column-block size (ops/locate.py)
) -> UngappedOut:
    """The ungapped device step, as three chained jit programs (seed +
    locate, verify, replay + select).  Every intermediate stays on the
    device; the split costs two extra dispatches per batch."""
    # locate packs the seed offset into 11 bits (ops/locate.py)
    assert seq_f.shape[1] <= 2047, "reads longer than 2047bp unsupported"
    seq2, lc, loc_ovf = _se_seed_locate(
        dix, seq_f, seq_r, l_overlap=l_overlap, max_seed=max_seed,
        max_locate=max_locate, cap=cap, pe_mode=pe_mode, sampled=sampled,
        chunk=chunk,
    )
    v, ovf = _se_verify(dix, seq2, lc, loc_ovf, u=u)
    return _se_select(v, ovf, lc, k_hits=k_hits)


@partial(jax.jit, static_argnames=())
def _se_verify_full(
    dix: DeviceIndex,
    seq_f: jnp.ndarray,
    seq_r: jnp.ndarray,
    loci0: Loci,
    loci1: Loci,
):
    seq2 = jnp.concatenate([seq_f, seq_r], axis=0).astype(jnp.int32)
    lc = Loci(*(jnp.concatenate([a, b], axis=0)
                for a, b in zip(loci0, loci1)))
    chk = checked_mask(lc, dix.l_pac)
    pos, keep, _ = compact_loci(lc, chk, lc.pos.shape[-1])
    return mismatch_counts_packed(
        dix.mixref_words, pos, keep, seq2, NOGAP_MAX_DIFF + 1
    )


@partial(jax.jit, static_argnames=("k_hits",))
def _se_select_res(v: StrandVerify, k_hits: int) -> SEResult:
    B = v.counts.shape[0] // 2
    half = lambda a: (a[:B], a[B:])
    v0, v1 = (StrandVerify(*z) for z in zip(*map(half, v)))
    return replay_and_select(v0, v1, NOGAP_MAX_DIFF, k_hits)


def se_ungapped_full(
    dix: DeviceIndex,
    seq_f: jnp.ndarray,
    seq_r: jnp.ndarray,
    loci0: Loci,
    loci1: Loci,
    max_locate: int,
    cap: int,
    k_hits: int = 16,
) -> SEResult:
    """Full-width verify fallback for reads whose unique-candidate count
    exceeded the compact width (rare).  Reuses located loci."""
    v = _se_verify_full(dix, seq_f, seq_r, loci0, loci1)
    return _se_select_res(v, k_hits=k_hits)


class GappedOut(NamedTuple):
    res: SEResult
    overflow: jnp.ndarray


def _gapped_checked(loci: Loci, L: int, l_mref: int):
    B = loci.pos.shape[0]
    pos = loci.pos
    prev = jnp.concatenate(
        [jnp.full((B, 1), UINT32_MAX, dtype=pos.dtype), pos[:, :-1]], axis=1
    )
    end_u = pos + jnp.uint32(L + GAP_WINDOW_PAD)
    # skip rule of alnse_check_withgap (alnse.c:894), uint32 wraparound
    return loci.pushed & (pos != prev) & (end_u < jnp.uint32(l_mref))


def _gapped_verify(dix, loci, seq, u, k):
    B, L = seq.shape
    checked = _gapped_checked(loci, L, dix.l_pac)
    pos, keep, ovf = compact_loci(loci, checked, u)
    end_u = pos + jnp.uint32(L + GAP_WINDOW_PAD)
    in_ref = keep & (pos <= jnp.uint32(dix.l_pac)) & (end_u <= jnp.uint32(dix.l_pac))
    d = lv_distance_batch(
        dix.mixref_words,
        pos.astype(jnp.int32).reshape(-1),
        in_ref.reshape(-1),
        jnp.repeat(seq, u, axis=0),
        k,
        text_words=True,
    ).reshape(B, u)
    counts = jnp.where(keep, jnp.minimum(d, k + 1), 255)
    return StrandVerify(counts=counts, checked=keep, pos=pos), ovf


@partial(jax.jit, static_argnames=("k", "u"))
def _se_gapped_verify(
    dix: DeviceIndex,
    seq_f: jnp.ndarray,   # (Bg, L)
    seq_r: jnp.ndarray,
    loci0: Loci,          # (Bg, CAP) sorted
    loci1: Loci,
    k: int,
    u: int,
):
    seq2 = jnp.concatenate([seq_f, seq_r], axis=0).astype(jnp.int32)
    lc = Loci(*(jnp.concatenate([a, b], axis=0)
                for a, b in zip(loci0, loci1)))
    return _gapped_verify(dix, lc, seq2, u, k)


@partial(jax.jit, static_argnames=("k", "k_hits"))
def _se_gapped_select(v: StrandVerify, ovf: jnp.ndarray, k: int,
                      k_hits: int) -> GappedOut:
    B = v.counts.shape[0] // 2
    half = lambda a: (a[:B], a[B:])
    v0, v1 = (StrandVerify(*z) for z in zip(*map(half, v)))
    ovf0, ovf1 = half(ovf)
    res = replay_and_select(v0, v1, k, k_hits)
    return GappedOut(res=res, overflow=ovf0 | ovf1)


def se_gapped(
    dix: DeviceIndex,
    seq_f: jnp.ndarray,   # (Bg, L)
    seq_r: jnp.ndarray,
    loci0: Loci,          # (Bg, CAP) sorted
    loci1: Loci,
    k: int,
    u: int = 64,
    k_hits: int = 16,
) -> GappedOut:
    """Gapped (Landau-Vishkin) check, split at the verify/replay
    boundary like se_ungapped."""
    v, ovf = _se_gapped_verify(dix, seq_f, seq_r, loci0, loci1, k=k, u=u)
    return _se_gapped_select(v, ovf, k=k, k_hits=k_hits)
