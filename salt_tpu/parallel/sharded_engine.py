"""Sharded-index SE/PE alignment engine: the full aligner (ungapped +
gapped LV + overflow re-runs + XA/SAM emission, and PE pairing on top)
running against an index sharded by reference bin over a device mesh
(SURVEY.md §2.6, BASELINE config 5).

Round-2 state was ungapped-only with a host-numpy merge; this engine
moves the cross-shard merge onto the device (all_gather over the `shard`
mesh axis + the same vectorized threshold replay the monolithic step
uses) and plugs into the monolithic host finalize unchanged, so the
sharded path emits byte-identical SAM to the monolithic engine wherever
the reference's own caps don't truncate (and identically on the oracle
fixture — tests/test_sharded_engine.py asserts it byte-for-byte).

Merge exactness: each shard's replay (ops/verify.replay_and_select,
mirroring alnse.c:348-393) uses shard-local running thresholds >= the
global ones, so every monolithic survivor survives its own shard's
replay; re-running the replay over the position-sorted union reproduces
the monolithic hit lists exactly provided no shard truncated its K-wide
list — per-shard lists are kept at the verify width `u`, which bounds
survivors per strand per shard, so truncation cannot happen.

Device layout: every shard's sub-index rides one mesh device
(`stack_indexes`); read batches are replicated; hit lists are
all-gathered (n_shards * B * 2 * u int32 — a few MB) while the big
per-shard locate streams stay resident on their own device between the
ungapped and gapped programs.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..constants import NOGAP_MAX_DIFF, UINT32_MAX
from ..index.build import SaltIndex
from ..ops.locate import Loci
from ..ops.verify import StrandVerify, replay_and_select
from ..pipeline.engine import SEAligner, SEOptions
from ..pipeline.se import pack_result, se_gapped, se_ungapped, unpack_result
from .sharded import StackedIndex, build_sharded_indexes, stack_indexes


def merged_replay(hpos: jnp.ndarray, hnd: jnp.ndarray, max_diff0: int,
                  k_hits: int):
    """Re-run the sequential threshold replay over the union of per-shard
    survivor lists, on device.  hpos: (S, B, 2, K) uint32 global coords
    (0xFFFFFFFF = empty); hnd: (S, B, 2, K) int32.  Returns SEResult."""
    S, B, _, K = hpos.shape
    cp = jnp.moveaxis(hpos, 0, 2).reshape(B, 2, S * K)
    cn = jnp.moveaxis(hnd, 0, 2).reshape(B, 2, S * K)
    # position-sort per strand; equal real positions cannot span shards
    # (disjoint bins), so stability is only for determinism of sentinels
    cp_s, cn_s = jax.lax.sort([cp, cn], dimension=2, num_keys=1,
                              is_stable=True)
    valid = cp_s != jnp.uint32(UINT32_MAX)

    def mk(s):
        return StrandVerify(
            counts=jnp.where(valid[:, s], cn_s[:, s], 255),
            checked=valid[:, s],
            pos=cp_s[:, s],
        )

    return replay_and_select(mk(0), mk(1), max_diff0, k_hits)


def _shard_hits_global(res, base_off, lpac_true):
    """Lift a per-shard SEResult's hit lists into global coordinates,
    masking hits that fall into the stacked-padding tail."""
    hok = (res.hits_pos < lpac_true.astype(jnp.uint32)) & (
        res.hits_ndiff < 255
    )
    hpos = jnp.where(hok, res.hits_pos + base_off, jnp.uint32(UINT32_MAX))
    hnd = jnp.where(hok, res.hits_ndiff, 255)
    return hpos, hnd


class ShardedSEAligner(SEAligner):
    """Drop-in SEAligner whose device step runs over a sharded index.

    `index` is the monolithic host index (finalize/SAM only — it is
    never uploaded to a device); the device tables come from the
    per-shard sub-indexes."""

    def __init__(
        self,
        index: SaltIndex,
        shard_indexes: List[SaltIndex],
        opts: SEOptions = None,
        mesh: Optional[Mesh] = None,
        bins=None,
        contig_lengths=None,
    ):
        self.index = index
        self.opts = opts or SEOptions()
        if self.opts.sa_mode == "sampled":
            raise ValueError(
                "sharded mode keeps each shard's full SA (shards are "
                "small by construction); use sa_mode='full'"
            )
        n = len(shard_indexes)
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()[:n]), ("shard",))
        if mesh.devices.size != n:
            raise ValueError(f"mesh has {mesh.devices.size} devices for "
                             f"{n} shards")
        self.mesh = mesh
        self.n_shards = n
        if bins is None:
            bins = [[i] for i in range(n)]
        if contig_lengths is None:
            contig_lengths = [c.length for c in index.contigs]
        # coordinate lifting (global = shard-local + base) requires each
        # bin to be a contiguous run of contigs in global order
        for b in bins:
            if b != list(range(b[0], b[0] + len(b))):
                raise ValueError(
                    "sharded aligner needs contiguous contig bins "
                    "(partition_contigs_contiguous)"
                )
        self.stacked = stack_indexes(shard_indexes, bins,
                                     contig_lengths=contig_lengths)
        self.shard_l_pac = jnp.asarray(
            [ix.l_pac for ix in shard_indexes], dtype=jnp.int32
        )
        self._offsets = np.array([c.offset for c in index.contigs])
        self.sampled = None
        # device placement of the stacked tables, once
        self._tree_dev = jax.tree_util.tree_map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P(*(["shard"] + [None] * (a.ndim - 1))))
            ),
            self.stacked.tree,
        )
        self._base_dev = jax.device_put(
            jnp.asarray(self.stacked.base_offsets),
            NamedSharding(mesh, P("shard")),
        )
        self._lpac_dev = jax.device_put(
            self.shard_l_pac, NamedSharding(mesh, P("shard"))
        )
        self._progs = {}

    # ---------------- device programs ----------------

    def _rep(self, arr):
        return jax.device_put(arr, NamedSharding(self.mesh, P()))

    def _prog_ungapped(self, cap, u, k_hits, pe_mode):
        key = ("ung", cap, u, k_hits, pe_mode)
        if key in self._progs:
            return self._progs[key]
        mesh = self.mesh
        o = self.opts

        def step(tree, base_off, lpac, sf, sr):
            tree = jax.tree_util.tree_map(lambda a: a[0], tree)
            base_off = base_off[0].astype(jnp.uint32)
            lpac = lpac[0]
            out = se_ungapped(
                tree, sf, sr,
                l_overlap=o.l_overlap, max_seed=o.max_seed,
                max_locate=o.max_locate, cap=cap, u=u, k_hits=u,
                pe_mode=pe_mode,
            )
            hpos, hnd = _shard_hits_global(out.res, base_off, lpac)
            ghp = jax.lax.all_gather(hpos, "shard")
            ghn = jax.lax.all_gather(hnd, "shard")
            merged = merged_replay(ghp, ghn, NOGAP_MAX_DIFF, k_hits)
            ovf = jax.lax.psum(
                out.overflow.astype(jnp.int32), "shard") > 0
            packed = pack_result(merged, (ovf,))
            return (
                packed[None],
                out.loci0.pos[None], out.loci0.pushed[None],
                out.loci1.pos[None], out.loci1.pushed[None],
            )

        fn = shard_map(
            step,
            mesh=mesh,
            in_specs=(
                jax.tree_util.tree_map(lambda _: P("shard"),
                                       self.stacked.tree),
                P("shard"), P("shard"), P(), P(),
            ),
            out_specs=(P("shard"),) * 5,
            check_vma=False,
        )
        fn = jax.jit(fn)
        self._progs[key] = fn
        return fn

    def _prog_gapped(self, cap, k, u, k_hits):
        key = ("gap", cap, k, u, k_hits)
        if key in self._progs:
            return self._progs[key]
        mesh = self.mesh
        o = self.opts

        def step(tree, base_off, lpac, lp0, lk0, lp1, lk1, sel, rsel, sf,
                 sr):
            # sel picks rows of the loci arrays, rsel the same reads in
            # the batch (they differ for the full-cap re-run's loci)
            tree = jax.tree_util.tree_map(lambda a: a[0], tree)
            base_off = base_off[0].astype(jnp.uint32)
            lpac = lpac[0]
            loci0 = Loci(pos=lp0[0][sel], pushed=lk0[0][sel])
            loci1 = Loci(pos=lp1[0][sel], pushed=lk1[0][sel])
            g = se_gapped(
                tree, sf[rsel], sr[rsel], loci0, loci1, k=k, u=u, k_hits=u,
            )
            hpos, hnd = _shard_hits_global(g.res, base_off, lpac)
            ghp = jax.lax.all_gather(hpos, "shard")
            ghn = jax.lax.all_gather(hnd, "shard")
            merged = merged_replay(ghp, ghn, k, k_hits)
            ovf = jax.lax.psum(g.overflow.astype(jnp.int32), "shard") > 0
            return pack_result(merged, (ovf,))[None]

        fn = shard_map(
            step,
            mesh=mesh,
            in_specs=(
                jax.tree_util.tree_map(lambda _: P("shard"),
                                       self.stacked.tree),
                P("shard"), P("shard"),
                P("shard"), P("shard"), P("shard"), P("shard"),
                P(), P(), P(), P(),
            ),
            out_specs=P("shard"),
            check_vma=False,
        )
        fn = jax.jit(fn)
        self._progs[key] = fn
        return fn

    # ---------------- engine hooks ----------------

    def _dispatch_batch(self, codes: np.ndarray):
        from ..utils.metrics import stage
        from ..pipeline.engine import revcomp

        o = self.opts
        with stage("device.dispatch"):
            fwd = self._rep(jnp.asarray(codes.astype(np.int32)))
            rev = self._rep(jnp.asarray(revcomp(codes).astype(np.int32)))
            fn = self._prog_ungapped(o.cap(), o.verify_width, o.k_hits,
                                     o.pe_locate)
            packed, lp0, lk0, lp1, lk1 = fn(
                self._tree_dev, self._base_dev, self._lpac_dev, fwd, rev
            )
        return fwd, rev, (lp0, lk0, lp1, lk1), packed

    def _complete_batch(self, handle):
        from ..utils.metrics import stage

        o = self.opts
        K = o.k_hits
        fwd, rev, loci_dev, packed_dev = handle
        L = fwd.shape[1]
        with stage("device.ungapped"):
            packed = np.asarray(packed_dev)[0]  # shard 0's (replicated) copy
        res = unpack_result(packed, K)
        needs_gap = ~res["found"]
        overflow = res["n_extra"][:, 0].astype(bool)

        # overflow rows: re-run the whole sharded ungapped step at full
        # cap/width (rare), exactly as the monolithic engine does
        full_res = {}
        full_loci = {}   # row -> device loci arrays at FULL cap
        ovf_rows = np.nonzero(overflow)[0]
        if len(ovf_rows):
            sub = o.gap_batch
            with stage("device.ungapped_full"):
                for s0 in range(0, len(ovf_rows), sub):
                    rr = ovf_rows[s0 : s0 + sub]
                    sel = np.concatenate(
                        [rr, np.zeros(sub - len(rr), dtype=rr.dtype)]
                    )
                    selr = self._rep(jnp.asarray(sel))
                    fullfn = self._prog_ungapped(
                        o.full_cap(), o.full_cap(), K, o.pe_locate
                    )
                    fp, flp0, flk0, flp1, flk1 = fullfn(
                        self._tree_dev, self._base_dev, self._lpac_dev,
                        jnp.take(fwd, selr, axis=0),
                        jnp.take(rev, selr, axis=0),
                    )
                    fr = unpack_result(np.asarray(fp)[0][: len(rr)], K)
                    for i, r in enumerate(rr):
                        full_res[int(r)] = {k: v[i] for k, v in fr.items()}
                        full_loci[int(r)] = (
                            (flp0, flk0, flp1, flk1), i, len(sel)
                        )
                        needs_gap[r] = not bool(fr["found"][i])

        if o.extend_algo == "sw":
            sw_res = {}
            gap_rows = np.nonzero(needs_gap)[0]
            if len(gap_rows):
                self._sw_extend_sharded(gap_rows, loci_dev, full_loci,
                                        int(L), fwd, rev, sw_res)
            return res, needs_gap, sw_res, full_res

        gap_res = {}
        gap_rows = np.nonzero(needs_gap)[0]
        if len(gap_rows):
            k = o.gap_k if o.gap_k is not None else max(int(L) // 10, 0)
            norm_rows = np.array(
                [r for r in gap_rows if r not in full_loci], dtype=np.int64
            )
            lp0, lk0, lp1, lk1 = loci_dev
            if len(norm_rows):
                self._run_gapped_rows(
                    norm_rows, o.gap_batch, o.cap(), k, o.verify_width, K,
                    (lp0, lk0, lp1, lk1), fwd, rev, gap_res, retry_wide=True,
                )
            ovf_gap = [r for r in gap_rows if r in full_loci]
            if ovf_gap:
                # gapped check against the FULL-cap loci of the re-run;
                # rows sharing one re-run sub-batch are grouped
                by_batch = {}
                for r in ovf_gap:
                    arrs, i, _n = full_loci[r]
                    by_batch.setdefault(id(arrs), (arrs, []))[1].append(
                        (r, i)
                    )
                for arrs, pairs in by_batch.values():
                    rows = np.array([r for r, _ in pairs])
                    sel_local = np.array([i for _, i in pairs])
                    self._run_gapped_rows(
                        rows, 8, o.full_cap(), k, o.full_cap(), K,
                        arrs, fwd, rev, gap_res, retry_wide=False,
                        sel_override=sel_local,
                    )
        return res, needs_gap, gap_res, full_res

    def _run_gapped_rows(self, rows, sub, cap, k, u, K, loci_arrs, fwd, rev,
                         gap_res, retry_wide, sel_override=None):
        """Run the sharded gapped program over `rows` in fixed sub-batches
        and decode into gap_res; rows whose gapped verify overflowed the
        compact width are re-run at the full cap width."""
        from ..utils.metrics import stage

        lp0, lk0, lp1, lk1 = loci_arrs
        o = self.opts
        ovf_retry = []
        with stage("device.gapped"):
            for s0 in range(0, len(rows), sub):
                rr = rows[s0 : s0 + sub]
                sel_rows = (sel_override[s0 : s0 + sub]
                            if sel_override is not None else rr)
                pad = np.zeros(sub - len(rr), dtype=np.int32)
                sel = np.concatenate([sel_rows, pad]).astype(np.int32)
                rsel = np.concatenate([rr, pad]).astype(np.int32)
                fn = self._prog_gapped(cap, k, u, K)
                gp = fn(
                    self._tree_dev, self._base_dev, self._lpac_dev,
                    lp0, lk0, lp1, lk1, self._rep(jnp.asarray(sel)),
                    self._rep(jnp.asarray(rsel)), fwd, rev,
                )
                gr = unpack_result(np.asarray(gp)[0][: len(rr)], K)
                for i, r in enumerate(rr):
                    gap_res[int(r)] = {kk: v[i] for kk, v in gr.items()}
                    if retry_wide and bool(gr["n_extra"][i, 0]):
                        ovf_retry.append(
                            (r, sel_rows[i] if sel_override is not None
                             else r)
                        )
        if ovf_retry:
            rows2 = np.array([r for r, _ in ovf_retry])
            sel2 = np.array([s for _, s in ovf_retry])
            self._run_gapped_rows(
                rows2, 8, cap, k, cap, K, loci_arrs, fwd, rev, gap_res,
                retry_wide=False, sel_override=sel2,
            )

    def _sw_extend_sharded(self, rows, loci_dev, full_loci, L, fwd, rev,
                           sw_res):
        """-X 1 on the sharded path: materialize the selected rows'
        per-shard loci, lift to global coordinates, merge-sort into the
        monolithic scan order, then reuse the winner-selection host SW."""
        lp0, lk0, lp1, lk1 = loci_dev
        n = len(rows)
        # bucket the selection width so the jitted lift compiles per
        # bucket, not per batch; pad rows repeat row 0 (ignored below)
        bucket = 8
        while bucket < n:
            bucket *= 2
        sel_rows = np.zeros(bucket, dtype=np.int32)
        sel_rows[:n] = rows
        fn = self._lift_prog(bucket)
        g0d, g1d = fn(lp0, lk0, lp1, lk1, self._rep(jnp.asarray(sel_rows)),
                      self._base_dev, self._lpac_dev)
        g0 = np.asarray(g0d)[:n]
        g1 = np.asarray(g1d)[:n]
        k0 = g0 != np.uint32(UINT32_MAX)
        k1 = g1 != np.uint32(UINT32_MAX)

        class _O:
            pass

        out = _O()
        # present as full-(B,) arrays via an indexable shim: build dense
        # arrays only over the selected rows
        B = fwd.shape[0]
        CAPW = g0.shape[1]

        def densify(g, kx):
            posd = np.full((B, CAPW), np.uint32(UINT32_MAX), np.uint32)
            pushd = np.zeros((B, CAPW), bool)
            posd[rows] = g
            pushd[rows] = kx
            return Loci(pos=jnp.asarray(posd), pushed=jnp.asarray(pushd))

        out.loci0 = densify(g0, k0)
        out.loci1 = densify(g1, k1)
        # full-cap overflow rows: their loci came from the full-cap
        # re-run arrays; lift those the same way
        fl = {}
        for r, (arrs, i, nsel) in full_loci.items():
            fa0, fk0, fa1, fk1 = arrs
            ga, ka = self._lift_one(fa0, fk0, i)
            gb, kb = self._lift_one(fa1, fk1, i)
            fl[r] = ((ga, ka), (gb, kb))
        self._sw_extend(rows, out, fl, L, fwd, rev, sw_res)

    def _lift_prog(self, n_sel):
        """Device-side cross-shard loci lift for the -X 1 path: gather
        the selected rows' per-shard loci, mask to in-shard, add the
        shard base offsets, and merge-sort into the monolithic global
        scan order — all on the mesh (the old host-numpy lift
        materialized per-shard loci on the host, a cliff at
        whole-genome shard counts)."""
        key = ("lift", n_sel)
        if key in self._progs:
            return self._progs[key]
        import jax.numpy as jnp

        @jax.jit
        def f(lp0, lk0, lp1, lk1, sel, base, lpac):
            def one(lp, lk):
                p = lp[:, sel]                       # (S, n_sel, CAP)
                ok = lk[:, sel] & (p < lpac[:, None, None].astype(jnp.uint32))
                g = jnp.where(ok, p + base[:, None, None].astype(jnp.uint32),
                              jnp.uint32(UINT32_MAX))
                g = jnp.moveaxis(g, 0, 1).reshape(n_sel, -1)
                (gs,) = jax.lax.sort([g], dimension=1, num_keys=1)
                return gs

            return one(lp0, lk0), one(lp1, lk1)

        self._progs[key] = f
        return f

    def _lift_one(self, lp, lk, i):
        base = self.stacked.base_offsets.astype(np.uint32)
        lpac = np.asarray(self.shard_l_pac)
        p = np.asarray(lp[:, i])        # (S, CAP)
        kk = np.asarray(lk[:, i])
        ok = kk & (p < lpac[:, None].astype(np.uint32))
        g = np.where(ok, p + base[:, None], np.uint32(UINT32_MAX))
        g = g.reshape(-1)
        g.sort()
        return g, g != np.uint32(UINT32_MAX)


class ShardedPEAligner:
    """PE alignment over a sharded index: the per-end SE stage runs on
    the shard mesh via ShardedSEAligner; pairing, SSW rescue, and SAM
    emission reuse the monolithic PE host machinery unchanged (they
    operate on global coordinates against the host index)."""

    def __new__(cls, index, shard_indexes, opts=None, mesh=None, bins=None,
                contig_lengths=None):
        from ..pipeline.pe_engine import PEAligner, PEOptions

        self = PEAligner.__new__(PEAligner)
        self.index = index
        self.opts = opts or PEOptions()
        se_opts = SEOptions(**{
            k: getattr(self.opts, k) for k in SEOptions.__dataclass_fields__
        })
        se_opts.pe_locate = True
        se_opts.gap_k = 3
        self._se = ShardedSEAligner(
            index, shard_indexes, opts=se_opts, mesh=mesh, bins=bins,
            contig_lengths=contig_lengths,
        )
        self._offsets = np.array([c.offset for c in index.contigs])
        return self


def build_sharded_se(contig_data, blocks, n_shards, opts=None, mesh=None,
                     l_seed=19, r_anchor_mode="exact", paired=False):
    """Partition (contiguous bins) + build monolithic host index + build
    per-shard sub-indexes + construct the aligner, in one call (used by
    tests and `cli aln --shards`)."""
    from ..index.build import build_index_from_data
    from .sharded import partition_contigs_contiguous

    lengths = [len(c[2]) for c in contig_data]
    bins = partition_contigs_contiguous(lengths, n_shards)
    index = build_index_from_data(contig_data, blocks, l_seed=l_seed,
                                  r_anchor_mode=r_anchor_mode)
    shard_indexes = []
    for b in bins:
        cd = [contig_data[i] for i in b]
        bl = [blocks[i] for i in b if i < len(blocks)]
        shard_indexes.append(
            build_index_from_data(cd, bl, l_seed=l_seed,
                                  r_anchor_mode=r_anchor_mode)
        )
    cls = ShardedPEAligner if paired else ShardedSEAligner
    return cls(index, shard_indexes, opts=opts, mesh=mesh, bins=bins,
               contig_lengths=lengths)
