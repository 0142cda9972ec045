"""Host-side SE alignment engine: batching, device dispatch, hit
finalization (query_set_hits semantics) and SAM record assembly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import os

import jax
import jax.numpy as jnp
import numpy as np

# Persistent XLA compilation cache: the pipeline's fixed-shape programs
# compile once per (batch-shape, option) combination, not per process.
# JAX itself honours JAX_COMPILATION_CACHE_DIR; without it the cache
# lives at a fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache"))

from ..constants import (
    DEFAULT_MAX_LOCATE,
    DEFAULT_MAX_SEED,
    NST_NT4_TABLE,
    SE_MAX_N_AMBIGUOUS,
    UINT32_MAX,
)
from ..index.build import SaltIndex
from ..utils.metrics import count, device_trace, progress, stage
from ..io.fasta import read_records, trim_readno
from ..io.sam import build_xa, emit_se, sam_header
from ..ops.lv import NT2BIT_NP, lv_cigar_host
from .device_index import DeviceIndex, to_device_index
from .se import (
    pack_result,
    se_gapped,
    se_ungapped,
    unpack_result,
)

_pack_ungapped = jax.jit(
    lambda res, needs_gap, ovf: pack_result(res, (needs_gap, ovf))
)
_pack_plain = jax.jit(lambda res: pack_result(res))
_pack_gapped = jax.jit(lambda g: pack_result(g.res, (g.overflow,)))


@dataclass
class SEOptions:
    l_overlap: int = 1
    max_seed: int = DEFAULT_MAX_SEED
    max_locate: int = DEFAULT_MAX_LOCATE
    max_hits: int = 5           # aln_opt->max_hits (aln.h:133)
    print_xa_cigar: bool = False
    print_nm_md: bool = False
    rg_id: Optional[str] = None
    batch_size: int = 4096
    gap_batch: int = 64
    k_hits: int = 16
    # SE-only: shrink the per-strand hit-list width to 8 when max_hits
    # is small (set_hits consumes at most max_hits+1 entries per strand,
    # query.c:297-333), halving the packed result download per batch.
    # PE keeps the full width — pairing2 crosses whole hit lists.
    auto_k_hits: bool = True
    cap_margin: int = 128
    verify_width: int = 64   # compact unique-candidate width (u)
    fast_cap: int = 0        # >0: locate slots in the fast pass; reads
                             # whose candidate stream exceeds it re-run at
                             # full_cap.  0 (default): single-tier — with
                             # stride-1 overlap seeding each locus appears
                             # in ~2*l_seed seed streams, so small caps
                             # overflow on most reads and the re-runs cost
                             # more than the narrow fast pass saves
    pe_locate: bool = False  # alnse_locate (PE) vs alnse_locate_alt caps
    gap_k: Optional[int] = None  # gapped threshold; None -> l_seq // 10
    # -X 1: Smith-Waterman extension instead of Landau-Vishkin for reads
    # with no ungapped hit (alnse_overlap_sw, alnse.c:1105-1164).  NOTE:
    # the reference binary aborts on its own -X 1 path (is_gap=-1 feeds
    # k=-1 into computeEditDistanceWithCigar's assert), so byte-parity is
    # undefined; this implements the evident intent: best SW locus wins,
    # SW cigar with soft clips, MAPQ from (score1, score2).
    extend_algo: str = "lv"      # "lv" | "sw"
    # index residency: "full" = one-gather locate (4B/rank of HBM);
    # "sampled" = bounded LF-walk locate at ~n/3 bytes total, fitting a
    # whole-human-genome index on a single chip (device_index.SampledSA)
    sa_mode: str = "full"
    sa_intv: int = 8
    # locate column-block size (ops/locate.py): None = per-mode default
    # (128-col chunked in sampled mode, flat in full mode); 0 = flat
    locate_chunk: Optional[int] = None
    sw_thres_score: int = 50     # aln_opt->thres_score (aln.h:144)
    sw_filterd: int = 20         # aln_opt->filterd (aln.h:142)
    # batched device SW pre-filter (see pe_engine.PEOptions / sw_batch.py):
    # candidates whose textbook score cannot win are skipped before the
    # exact host SSW.  "auto" = on when a batch has at least
    # device_sw_min_batch candidates to amortize the dispatch (for -X 1
    # extension; PE rescue stays on the host under "auto").
    device_sw: str = "auto"      # "auto" | "on" | "off"
    device_sw_min_batch: int = 32

    def full_cap(self) -> int:
        c = self.max_locate + self.cap_margin
        return ((c + 63) // 64) * 64

    def cap(self) -> int:
        if self.fast_cap <= 0:
            return self.full_cap()
        return min(self.full_cap(), ((self.fast_cap + 63) // 64) * 64)


def encode_reads(seqs: List[str]) -> np.ndarray:
    """Encode a uniform-length group of reads (callers group mixed-length
    input by exact length first — see group_by_length)."""
    L = len(seqs[0])
    arr = np.zeros((len(seqs), L), dtype=np.uint8)
    for i, s in enumerate(seqs):
        if len(s) != L:
            raise ValueError(
                f"encode_reads needs uniform lengths (got {len(s)} vs {L}); "
                "group mixed-length reads with group_by_length first"
            )
        arr[i] = NST_NT4_TABLE[np.frombuffer(s.encode("latin1"), dtype=np.uint8)]
    return arr


def group_by_length(seqs) -> List[tuple]:
    """[(length, [orig_index, ...])], ascending by length.  The reference
    tracks per-read l_seq and aligns whatever lengths arrive
    (Align_src/query.c:240-268); with XLA's static shapes we instead run
    one fixed-shape program per distinct length and scatter the results
    back into input order."""
    by_len = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)
    return sorted(by_len.items())


def revcomp(codes: np.ndarray) -> np.ndarray:
    r = codes[:, ::-1].copy()
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def gen_mapq(b0: int, b1: int) -> int:
    """query.c:270-281."""
    if b0 == 0:
        return 0
    mapq = int(255.0 * (abs(b0 - b1) / float(b0)))
    return mapq if mapq < 254 else 254


def set_hits_batch(primary_pos, n_diff, n_hits, first_hit_ndiff, hits_pos,
                   hits_ndiff, max_hits):
    """Vectorized query_set_hits (query.c:297-333) over a batch of
    reads: primary_pos (M,), n_diff (M,), n_hits (M,2),
    first_hit_ndiff (M,2), hits_pos (M,2,K), hits_ndiff (M,2,K).
    Returns (b1 (M,), appended (M,2,K) bool) where `appended` marks the
    XA entries the sequential reference loop records (strand-0 entries
    first, j order, pos != primary, a[0]-n_diff filter, max_hits cap
    with the early return) and b1 is min(a0) over strands that
    contributed at least one entry (100000 otherwise)."""
    M, S, K = hits_pos.shape
    pp = np.asarray(primary_pos, dtype=np.int64)
    nd = np.asarray(n_diff, dtype=np.int64)
    a0 = np.asarray(first_hit_ndiff, dtype=np.int64)
    hp = np.asarray(hits_pos, dtype=np.int64)
    j = np.arange(K)
    valid = j[None, None, :] < np.minimum(n_hits, K)[:, :, None]
    elig = (valid & (hp != pp[:, None, None])
            & (a0 <= nd[:, None])[:, :, None])
    cum = np.cumsum(elig.reshape(M, 2 * K), axis=1)
    appended = (elig.reshape(M, 2 * K)
                & (cum <= max_hits)).reshape(M, 2, K)
    contrib = appended.any(axis=2)
    b1 = np.where(contrib, a0, 100000).min(axis=1)
    return b1, appended


def gen_mapq_batch(b0, b1):
    """Vectorized gen_mapq (query.c:270-281)."""
    b0 = np.asarray(b0, dtype=np.int64)
    b1 = np.asarray(b1, dtype=np.int64)
    return np.where(
        b0 == 0, 0,
        np.minimum((255.0 * np.abs(b0 - b1)
                    / np.maximum(b0, 1)).astype(np.int64), 254))


def set_hits(
    primary_pos: int,
    primary_ndiff: int,
    n_hits: np.ndarray,          # (2,)
    first_hit_ndiff: np.ndarray, # (2,)
    hits_pos: np.ndarray,        # (2, K)
    hits_ndiff: np.ndarray,      # (2, K)
    max_hits: int,
):
    """query_set_hits (query.c:297-333) including the reference's use of
    the FIRST hit's n_diff (`a->n_diff`, i.e. a[0]) for the filter and b1.
    Returns (b1, xa_entries [(strand,pos,ndiff)...])."""
    b0 = primary_ndiff
    b1 = 100000
    tot = 0
    xa = []
    K = hits_pos.shape[1]
    for s in (0, 1):
        n = int(n_hits[s])
        if n == 0:
            continue
        a0 = int(first_hit_ndiff[s])
        for j in range(min(n, K)):
            pos = int(hits_pos[s, j])
            if pos == primary_pos:
                continue
            if a0 <= b0:
                if a0 <= b1:
                    b1 = a0
                xa.append((s, pos, int(hits_ndiff[s, j])))
                tot += 1
            if tot == max_hits:
                return b1, xa
    return b1, xa


class SEAligner:
    def __init__(self, index: SaltIndex, opts: SEOptions = None):
        self.index = index
        self.opts = opts or SEOptions()
        if self.opts.auto_k_hits and self.opts.max_hits <= 6:
            # copy before adjusting: the caller's options object may be
            # shared across aligners and must not be mutated
            import dataclasses as _dc
            self.opts = _dc.replace(
                self.opts, k_hits=min(self.opts.k_hits, 8))
        if self.opts.sa_mode == "sampled":
            self.dix, self.sampled = to_device_index(
                index, sa_mode="sampled", sa_intv=self.opts.sa_intv
            )
        else:
            self.dix = to_device_index(index)
            self.sampled = None
        self._offsets = np.array([c.offset for c in index.contigs])

    # ---------------- device dispatch ----------------

    def _subbatch_packed(self, fn, rows, fixed):
        """Run `fn` (returning a packed int32 matrix) over `rows` in
        fixed-size padded sub-batches; returns a packed matrix aligned
        with `rows`."""
        parts = []
        for start in range(0, len(rows), fixed):
            rr = rows[start : start + fixed]
            pad = fixed - len(rr)
            rows_p = np.concatenate([rr, np.zeros(pad, dtype=rr.dtype)])
            sub = np.asarray(fn(jnp.asarray(rows_p)))
            parts.append(sub[: len(rr)])
        return np.concatenate(parts, axis=0)

    def _dispatch_batch(self, codes: np.ndarray):
        """Launch the ungapped step for one padded batch; returns an
        opaque handle.  JAX dispatch is async, so the device starts
        immediately while the host moves on (pipelining)."""
        o = self.opts
        with stage("device.dispatch"):
            # ship reads as uint8 (4x fewer bytes than int32); the
            # device step casts to int32 on entry
            fwd = jnp.asarray(codes)
            rev = jnp.asarray(revcomp(codes))
            out = se_ungapped(
                self.dix, fwd, rev,
                l_overlap=o.l_overlap, max_seed=o.max_seed,
                max_locate=o.max_locate, cap=o.cap(), u=o.verify_width,
                k_hits=o.k_hits, pe_mode=o.pe_locate, sampled=self.sampled,
                chunk=o.locate_chunk,
            )
            packed_dev = _pack_ungapped(out.res, out.needs_gap, out.overflow)
        return fwd, rev, out, packed_dev

    def _run_batch(self, codes: np.ndarray):
        """codes: (B, L) uint8.  Returns per-read numpy result dicts:
        (ungapped, needs_gap mask, gapped dict row->result, full dict)."""
        return self._complete_batch(self._dispatch_batch(codes))

    def _complete_batch(self, handle):
        o = self.opts
        K = o.k_hits
        fwd, rev, out, packed_dev = handle
        L = fwd.shape[1]
        with stage("device.ungapped"):
            packed = np.asarray(packed_dev)
        res = unpack_result(packed, K)
        needs_gap = res["n_extra"][:, 0].astype(bool)
        overflow = res["n_extra"][:, 1].astype(bool)
        take = jax.tree_util.tree_map

        # rows whose locate/verify hit the fast-path width: re-run the
        # whole ungapped step at full cap + full verify width (rare)
        full_res = {}
        full_loci = {}   # row -> (loci0_row, loci1_row) at FULL cap
        ovf_rows = np.nonzero(overflow)[0]
        if len(ovf_rows):
            sub = o.gap_batch
            with stage("device.ungapped_full"):
                for s0 in range(0, len(ovf_rows), sub):
                    rr = ovf_rows[s0 : s0 + sub]
                    sel = np.concatenate(
                        [rr, np.zeros(sub - len(rr), dtype=rr.dtype)]
                    )
                    out_f = se_ungapped(
                        self.dix, fwd[jnp.asarray(sel)], rev[jnp.asarray(sel)],
                        l_overlap=o.l_overlap, max_seed=o.max_seed,
                        max_locate=o.max_locate, cap=o.full_cap(),
                        u=o.full_cap(), k_hits=K, pe_mode=o.pe_locate,
                        sampled=self.sampled, chunk=o.locate_chunk,
                    )
                    fp = np.asarray(_pack_ungapped(
                        out_f.res, out_f.needs_gap, out_f.overflow))
                    l0 = jax.tree_util.tree_map(np.asarray, out_f.loci0)
                    l1 = jax.tree_util.tree_map(np.asarray, out_f.loci1)
                    fr = unpack_result(fp[: len(rr)], K)
                    for i, r in enumerate(rr):
                        full_res[int(r)] = {k: v[i] for k, v in fr.items()}
                        full_loci[int(r)] = (
                            (l0.pos[i], l0.pushed[i]), (l1.pos[i], l1.pushed[i])
                        )
                        needs_gap[r] = not bool(fr["found"][i])

        if o.extend_algo == "sw":
            sw_res = {}
            gap_rows = np.nonzero(needs_gap)[0]
            if len(gap_rows):
                with stage("host.sw_extend"):
                    self._sw_extend(gap_rows, out, full_loci, int(L),
                                    fwd, rev, sw_res)
            return res, needs_gap, sw_res, full_res

        gap_res = {}
        gap_rows = np.nonzero(needs_gap)[0]
        count("lv.reads", len(gap_rows))
        if len(gap_rows):
            k = o.gap_k if o.gap_k is not None else max(int(L) // 10, 0)

            def run_gap(sel, u):
                return _pack_gapped(
                    se_gapped(
                        self.dix, fwd[sel], rev[sel],
                        take(lambda a: a[sel], out.loci0),
                        take(lambda a: a[sel], out.loci1),
                        k=k, u=u, k_hits=K,
                    )
                )

            norm_rows = np.array(
                [r for r in gap_rows if r not in full_loci], dtype=np.int64
            )
            if len(norm_rows):
                with stage("device.gapped"):
                    gp = self._subbatch_packed(
                        lambda sel: run_gap(sel, o.verify_width), norm_rows,
                        o.gap_batch,
                    )
                gr = unpack_result(gp, K)
                for i, r in enumerate(norm_rows):
                    gap_res[int(r)] = {kk: v[i] for kk, v in gr.items()}
                govf = [r for i, r in enumerate(norm_rows)
                        if bool(gr["n_extra"][i, 0])]
                if govf:
                    gfp = self._subbatch_packed(
                        lambda sel: run_gap(sel, o.cap()), np.array(govf), 8
                    )
                    gfr = unpack_result(gfp, K)
                    for i, r in enumerate(govf):
                        gap_res[int(r)] = {kk: v[i] for kk, v in gfr.items()}

            # overflow rows: gapped check against their FULL-cap loci
            ovf_gap = [r for r in gap_rows if r in full_loci]
            if ovf_gap:
                from ..ops.locate import Loci as _Loci

                sub = 8
                with stage("device.gapped"):
                    for s0 in range(0, len(ovf_gap), sub):
                        rr = ovf_gap[s0 : s0 + sub]
                        pad = sub - len(rr)
                        rows = np.array(rr + [rr[-1]] * pad)
                        mk = lambda part: _Loci(
                            pos=jnp.asarray(np.stack(
                                [full_loci[r][part][0] for r in rows])),
                            pushed=jnp.asarray(np.stack(
                                [full_loci[r][part][1] for r in rows])),
                        )
                        gfp = np.asarray(_pack_gapped(se_gapped(
                            self.dix, fwd[jnp.asarray(rows)],
                            rev[jnp.asarray(rows)], mk(0), mk(1),
                            k=k, u=o.full_cap(), k_hits=K,
                        )))
                        gfr = unpack_result(gfp[: len(rr)], K)
                        for i, r in enumerate(rr):
                            gap_res[int(r)] = {kk: v[i] for kk, v in gfr.items()}
        return res, needs_gap, gap_res, full_res

    def _sw_extend(self, rows, out, full_loci, L, fwd, rev, sw_res):
        """Host SW extension over each gap-read's deduped loci
        (alnse_check_sw/sw_snp semantics; native SSW kernel), with an
        optional batched device pre-filter: a locus whose textbook SW
        score is below the current best cannot displace it (SSW's score
        never exceeds the textbook score, ops/sw_batch.py)."""
        from ..constants import SW_GAP_EXTEND, SW_GAP_OPEN
        from ..ops.lv import NT2BIT_NP
        from ..ops.ssw import SCORE_MAT16, ssw_align

        o = self.opts
        idx = self.index
        mix = idx.mixref
        sel = jnp.asarray(rows)
        loci_h = []
        for part in (out.loci0, out.loci1):
            loci_h.append((
                np.asarray(part.pos[sel]), np.asarray(part.pushed[sel])
            ))
        codes_f_rows = np.asarray(fwd[sel]).astype(np.uint8)
        codes_r_rows = np.asarray(rev[sel]).astype(np.uint8)

        # phase A: per read, the deduped in-range loci in scan order
        per_read = []   # (ri, codes_f, codes_r, [(strand, pos), ...])
        for i, r in enumerate(rows):
            ri = int(r)
            if ri in full_loci:
                strands = [
                    (full_loci[ri][0][0], full_loci[ri][0][1]),
                    (full_loci[ri][1][0], full_loci[ri][1][1]),
                ]
            else:
                strands = [
                    (loci_h[0][0][i], loci_h[0][1][i]),
                    (loci_h[1][0][i], loci_h[1][1][i]),
                ]
            cand = []
            for strand, (ps, ks) in enumerate(strands):
                prev = None
                for pos, pushed in zip(ps.tolist(), ks.tolist()):
                    if not pushed:
                        continue
                    pos = int(pos)
                    if pos == prev or pos + L + 4 >= len(mix):
                        continue
                    prev = pos
                    cand.append((strand, pos))
            per_read.append((ri, codes_f_rows[i], codes_r_rows[i], cand))

        pre = self._sw_extend_prefilter(per_read, L)

        for pi, (ri, codes_f, codes_r, cand) in enumerate(per_read):
            if not cand:
                continue
            reads = (NT2BIT_NP[np.minimum(codes_f, 4)].astype(np.int8),
                     NT2BIT_NP[np.minimum(codes_r, 4)].astype(np.int8))
            best = None
            done = False
            if pre is not None:
                # common path: ONE host SSW call.  The reference's loop
                # (accept if score1 >= running-best && span >= filterd)
                # ends on the LAST max-score candidate; the device
                # textbook scores bound SSW's (ssw <= textbook,
                # sw_batch.py), so the last textbook-argmax is the only
                # possible final winner.  Verify the assumption on the
                # winner itself (ssw score == device score, span passes)
                # and fall back to the exact sequential loop otherwise.
                sc = pre[pi]
                M = max(sc)
                if M > 0:
                    w = len(sc) - 1 - sc[::-1].index(M)
                    strand, pos = cand[w]
                    window = mix[pos : pos + L + 5].astype(np.int8)
                    rr = ssw_align(reads[strand], window, SCORE_MAT16,
                                   SW_GAP_OPEN, SW_GAP_EXTEND, L // 2)
                    if (rr.score1 == M and
                            rr.read_end1 - rr.read_begin1 + 1 >= o.sw_filterd):
                        best = (rr, pos, strand)
                        done = True
            if not done:
                b0 = -1
                for k, (strand, pos) in enumerate(cand):
                    if pre is not None and pre[pi][k] < max(b0, 0):
                        continue  # cannot reach the accept threshold
                    window = mix[pos : pos + L + 5].astype(np.int8)
                    rr = ssw_align(reads[strand], window, SCORE_MAT16,
                                   SW_GAP_OPEN, SW_GAP_EXTEND, L // 2)
                    if (rr.score1 >= b0 and
                            rr.read_end1 - rr.read_begin1 + 1 >= o.sw_filterd):
                        b0 = rr.score1
                        best = (rr, pos, strand)
            if best is not None:
                rr, pos, strand = best
                cig = ""
                if rr.read_begin1 != 0:
                    cig += f"{rr.read_begin1}S"
                cig += "".join(f"{c}{op}" for c, op in (rr.cigar or []))
                if rr.read_end1 != L - 1:
                    cig += f"{L - rr.read_end1 - 1}S"
                sw_res[ri] = {
                    "sw": True,
                    "found": True,
                    "pos": np.uint32(rr.ref_begin1 + pos),
                    "strand": strand,
                    "mapq": gen_mapq(rr.score1, rr.score2),
                    "cigar": cig,
                    "seq_start": rr.read_begin1,
                }

    def _sw_extend_prefilter(self, per_read, L):
        """Textbook SW scores for every (read, locus) SW-extension
        candidate, batched on device.  Returns [scores per read] or
        None when disabled."""
        o = self.opts
        if o.device_sw == "off":
            return None
        n_items = sum(len(c[3]) for c in per_read)
        if n_items == 0:
            return None
        if o.device_sw == "auto" and n_items < o.device_sw_min_batch:
            return None

        from ..constants import SW_GAP_EXTEND, SW_GAP_OPEN
        from ..ops.sw_batch import sw_score_rows

        mix = self.index.mixref
        W = L + 5
        refs = np.zeros((n_items, W), np.int32)
        reads = np.zeros((n_items, L), np.int32)
        lens = np.full(n_items, W, np.int32)
        k = 0
        for ri, codes_f, codes_r, cand in per_read:
            oh = (NT2BIT_NP[np.minimum(codes_f, 4)],
                  NT2BIT_NP[np.minimum(codes_r, 4)])
            for strand, pos in cand:
                refs[k] = mix[pos : pos + W]
                reads[k] = oh[strand]
                k += 1
        sc = sw_score_rows(refs, reads, lens, snp_mode=True,
                           gap_open=SW_GAP_OPEN, gap_extend=SW_GAP_EXTEND)
        count("sw.device.extend", n_items)
        out = []
        k = 0
        for _ri, _cf, _cr, cand in per_read:
            out.append(sc[k : k + len(cand)].tolist())
            k += len(cand)
        return out

    # ---------------- per-read finalization ----------------

    def _emit_sw(self, name, seq, rseq, qual, r) -> str:
        o = self.opts
        return emit_se(
            self.index, name, seq, rseq, qual, int(r["pos"]),
            int(r["strand"]), int(r["mapq"]), r["cigar"], "",
            o.print_nm_md, o.rg_id, seq_start=int(r["seq_start"]),
        )

    def _finalize_read(
        self, name, seq, rseq, qual, found, pos, strand, n_diff, is_gap,
        n_hits, first_hit_ndiff, hits_pos, hits_ndiff, md_tag=None,
        pre_hits=None,
    ) -> str:
        o = self.opts
        idx = self.index
        L = len(seq)
        if not found:
            return emit_se(idx, name, seq, rseq, qual, UINT32_MAX, 3, 0, "", "",
                           o.print_nm_md, o.rg_id)
        if pre_hits is not None:
            b1, xa_entries = pre_hits
        else:
            b1, xa_entries = set_hits(
                pos, n_diff, n_hits, first_hit_ndiff, hits_pos, hits_ndiff,
                o.max_hits,
            )
        mapq = gen_mapq(n_diff, b1)
        # primary cigar (query_gen_cigar, query.c:282-296)
        if is_gap:
            e, cigar = self._lv_cigar(pos, seq if strand == 0 else rseq, n_diff)
            md_tag = None
        else:
            cigar = f"{L}M"
        # XA cigars
        xa_with_cig = []
        for s, p, nd in xa_entries:
            cig = None
            if o.print_xa_cigar and is_gap:
                _, cig = self._lv_cigar(p, seq if s == 0 else rseq, nd)
            xa_with_cig.append((s, p, nd, cig))
        xa = build_xa(idx, pos, L, xa_with_cig, o.print_xa_cigar)
        return emit_se(idx, name, seq, rseq, qual, pos, strand, mapq, cigar,
                       xa, o.print_nm_md, o.rg_id, md_tag=md_tag)

    def _lv_cigar(self, pos, strand_seq, k):
        L = len(strand_seq)
        text = self.index.mixref[pos : pos + L + 4]
        pattern = NT2BIT_NP[np.minimum(strand_seq, 4)]
        return lv_cigar_host(text, pattern, int(k))

    # ---------------- file-level driver ----------------

    def align_records(self, records) -> List[str]:
        """records: list of SeqRecord.  Returns SAM record strings
        (one per read, no newline; empty string for skipped reads).
        Mixed-length input is grouped by exact length (one fixed-shape
        device program per distinct length) and re-scattered in order."""
        groups = group_by_length([r.seq for r in records])
        if len(groups) <= 1:
            return self._align_records_uniform(records)
        out: List[str] = [""] * len(records)
        for _L, idxs in groups:
            for i, line in zip(
                idxs, self._align_records_uniform([records[i] for i in idxs])
            ):
                out[i] = line
        return out

    def _align_records_uniform(self, records) -> List[str]:
        o = self.opts
        names = [trim_readno(r.name) for r in records]
        seqs = [r.seq for r in records]
        quals = [r.qual for r in records]
        codes = encode_reads(seqs)
        rcodes = revcomp(codes)
        n_amb = (codes > 3).sum(axis=1)

        B = o.batch_size
        n = len(records)
        out_records: List[str] = [""] * n
        starts = list(range(0, n, B))
        inflight: List = []  # [(start, nb, handle)] 2-deep software pipeline

        def dispatch(start):
            chunk = codes[start : start + B]
            nb = len(chunk)
            if nb < B:
                chunk = np.concatenate(
                    [chunk, np.zeros((B - nb, chunk.shape[1]), dtype=np.uint8)]
                )
            inflight.append((start, nb, self._dispatch_batch(chunk)))

        if starts:
            dispatch(starts[0])
        for si in range(len(starts)):
            if si + 1 < len(starts):
                dispatch(starts[si + 1])  # device works while host finalizes
            start, nb, handle = inflight.pop(0)
            with device_trace("se_batch"):
                res, needs_gap, gap_res, full_res = self._complete_batch(handle)
            _fin = stage("host.finalize")
            _fin.__enter__()
            # batch the pure-match MD/NM/XV tags: one pac gather + one
            # mismatch scan for every plain-path found read (the
            # overwhelming majority), instead of a per-read numpy call
            md_tags = {}
            if o.print_nm_md:
                plain = []
                for i in range(nb):
                    gi = start + i
                    if n_amb[gi] > SE_MAX_N_AMBIGUOUS:
                        continue
                    if needs_gap[i] and i in gap_res:
                        continue
                    r = full_res[i] if i in full_res else None
                    found = bool(r["found"]) if r else bool(res["found"][i])
                    if not found:
                        continue
                    p = int(r["pos"]) if r else int(res["pos"][i])
                    st = int(r["strand"]) if r else int(res["strand"][i])
                    plain.append((i, p, st))
                if plain:
                    pos_a = np.array([p for _i, p, _s in plain], np.int64)
                    rd = np.stack([
                        (rcodes if s else codes)[start + i]
                        for i, _p, s in plain
                    ])
                    from ..io.sam import md_nm_tags_batch

                    for (i, _p, _s), tag in zip(
                        plain, md_nm_tags_batch(self.index, pos_a, rd)
                    ):
                        md_tags[i] = tag
            # batched query_set_hits for the plain-path found rows (the
            # overwhelming majority): one numpy pass instead of a
            # per-read Python double loop over the hit lists
            plain_rows = np.array([
                i for i in range(nb)
                if n_amb[start + i] <= SE_MAX_N_AMBIGUOUS
                and not (needs_gap[i] and i in gap_res)
                and i not in full_res and bool(res["found"][i])
            ], dtype=np.int64)
            pre_map = {}
            if len(plain_rows):
                b1v, appv = set_hits_batch(
                    res["pos"][plain_rows], res["n_diff"][plain_rows],
                    res["n_hits"][plain_rows],
                    res["first_hit_ndiff"][plain_rows],
                    res["hits_pos"][plain_rows],
                    res["hits_ndiff"][plain_rows], o.max_hits,
                )
                hpv = res["hits_pos"][plain_rows]
                hnv = res["hits_ndiff"][plain_rows]
                any_xa = appv.any(axis=(1, 2))
                xa_map = {m: [] for m in np.nonzero(any_xa)[0]}
                for m, s, jj in zip(*(a.tolist() for a in np.nonzero(appv))):
                    xa_map[m].append((s, int(hpv[m, s, jj]),
                                      int(hnv[m, s, jj])))
                for m, i in enumerate(plain_rows.tolist()):
                    pre_map[i] = (int(b1v[m]), xa_map.get(m, []))
            for i in range(nb):
                gi = start + i
                if n_amb[gi] > SE_MAX_N_AMBIGUOUS:
                    out_records[gi] = ""  # reference emits a blank line
                    continue
                if needs_gap[i] and i in gap_res:
                    r = gap_res[i]
                    if r.get("sw"):
                        out_records[gi] = self._emit_sw(
                            names[gi], codes[gi], rcodes[gi], quals[gi], r
                        )
                        continue
                    is_gap = True
                elif i in full_res:
                    r = full_res[i]
                    is_gap = False
                else:
                    r = {k: v[i] for k, v in res.items()}
                    is_gap = False
                out_records[gi] = self._finalize_read(
                    names[gi], codes[gi], rcodes[gi], quals[gi],
                    bool(r["found"]), int(r["pos"]), int(r["strand"]),
                    int(r["n_diff"]), is_gap, r["n_hits"],
                    r["first_hit_ndiff"], r["hits_pos"], r["hits_ndiff"],
                    md_tag=md_tags.get(i), pre_hits=pre_map.get(i),
                )
            _fin.__exit__(None, None, None)
        return out_records

    def align_file(self, fastq_path: str, out_fh, cmd: str = "salt-tpu"):
        print(sam_header(self.index, cmd, self.opts.rg_id), file=out_fh)
        batch = []
        n_done = 0
        for rec in read_records(fastq_path):
            batch.append(rec)
            if len(batch) >= 100000:
                for line in self.align_records(batch):
                    print(line, file=out_fh)
                n_done += len(batch)
                progress(n_done)
                batch = []
        if batch:
            for line in self.align_records(batch):
                print(line, file=out_fh)
            n_done += len(batch)
            progress(n_done)
