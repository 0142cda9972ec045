"""Large-genome scale test: synthetic genome (chr21- to GRCh38-scale) +
SNP overlay; measures index build time / peak RSS and SE alignment
throughput.  The whole-genome path exercises the u32 SA-IS
(tools/sais.cpp salt_sais_u8_u32) and the sampled-SA runtime — the
answer here to the reference's incremental BWT-SW construction
(Index_src/bwt_gen.c:1400-1538).

  python tools/bench_large.py 3100000000 --build-only --save /tmp/big/idx
  python tools/bench_large.py 3100000000 --sa-mode sampled   # build+align
"""

import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.fasta import SeqRecord
from salt_tpu.io.snp import SnpBlock
from salt_tpu.pipeline.engine import SEAligner, SEOptions

GENOME_LEN = int(sys.argv[1]) if len(sys.argv) > 1 else 45_000_000
BUILD_ONLY = "--build-only" in sys.argv
SAVE_PREFIX = None
LOAD_PREFIX = None
SA_MODE = "full"
SNP_EVERY = 300            # ~1 SNP / 300bp (snp144Common density scale)
N_CONTIG = 4 if GENOME_LEN >= 1_000_000_000 else 1
BATCH = int(os.environ.get("SALT_TPU_BENCH_BATCH", "4096"))
GENOME_CONFIG = "uniform"
READ_INDEL_FRAC = 0.0
for i, a in enumerate(sys.argv):
    if a == "--save":
        SAVE_PREFIX = sys.argv[i + 1]
    if a == "--load":
        LOAD_PREFIX = sys.argv[i + 1]
    if a == "--sa-mode":
        SA_MODE = sys.argv[i + 1]
    if a == "--snp-every":
        SNP_EVERY = int(sys.argv[i + 1])
    if a == "--genome-config":     # "repeat": salt_tpu.sim.genome_gen
        GENOME_CONFIG = sys.argv[i + 1]
    if a == "--read-indels":       # fraction of reads carrying one indel
        READ_INDEL_FRAC = float(sys.argv[i + 1])
N_READS = BATCH * 3
L = 100


def rss_gb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def log(msg):
    print(f"[t+{time.time()-T00:7.1f}s rss {rss_gb():6.2f}GB] {msg}",
          flush=True)


T00 = time.time()
rng = np.random.default_rng(7)
lut = np.frombuffer(b"ACGTN", dtype=np.uint8)

if LOAD_PREFIX:
    # reload a saved bundle and reconstruct truth reads from it: pac
    # holds the reference codes (no Ns in the synthetic genomes) and
    # the mixRef nibble carries BOTH alleles, so the mutated-haplotype
    # base at a SNP is the nibble bit that isn't the reference's.
    from salt_tpu.index.store import load_index

    t0 = time.time()
    idx = load_index(LOAD_PREFIX)
    log(f"bundle loaded in {time.time()-t0:.1f}s "
        f"({idx.l_pac/1e6:.0f}M bases, {idx.r_text_len/1e6:.1f}M R chars)")
    GENOME_LEN = idx.l_pac
    codes = idx.pac
    nib = idx.mixref & np.uint8(15)
    alt_mask = nib & ~(np.uint8(1) << codes)
    is_snp = alt_mask != 0
    gpos = np.nonzero(is_snp)[0]
    # log2 of the remaining one-hot bit = the alternate allele code
    alt = np.zeros(len(gpos), np.uint8)
    am = alt_mask[gpos]
    for b in range(4):
        alt[am == (1 << b)] = b
    log(f"{len(gpos)/1e6:.2f}M SNP positions recovered from mixRef")
    build_s = 0.0
else:
    log(f"synthesizing {GENOME_LEN/1e6:.0f}MB {GENOME_CONFIG} genome, "
        f"{N_CONTIG} contigs...")
    if GENOME_CONFIG == "uniform":
        codes = rng.integers(0, 4, GENOME_LEN, dtype=np.int64).astype(np.uint8)
    else:
        from salt_tpu.sim.genome_gen import synthesize_genome

        codes = np.concatenate([
            c for _n, c in synthesize_genome(
                GENOME_LEN, N_CONTIG, seed=7, config=GENOME_CONFIG)
        ])

# SNPs at ~1/SNP_EVERY bp (global positions, then split per contig)
if not LOAD_PREFIX:
    from salt_tpu.sim.genome_gen import sample_snps

    gpos, alt, stype_all = sample_snps(codes, SNP_EVERY, rng)

    clen = GENOME_LEN // N_CONTIG
    contig_data = []
    blocks = []
    for ci in range(N_CONTIG):
        s0 = ci * clen
        s1 = GENOME_LEN if ci == N_CONTIG - 1 else (ci + 1) * clen
        # char array, NOT a python str: build_index_from_data takes uint8
        contig_data.append((f"chr{ci+1}", "synthetic", lut[codes[s0:s1]]))
        sel = (gpos >= s0) & (gpos < s1)
        blocks.append(SnpBlock(f"chr{ci+1}",
                               (gpos[sel] - s0).astype(np.uint32),
                               stype_all[sel]))
    log(f"{len(gpos)/1e6:.2f}M SNPs synthesized")

    t0 = time.time()
    idx = build_index_from_data(contig_data, blocks, l_seed=19)
    build_s = time.time() - t0
    log(f"index built in {build_s:.1f}s "
        f"(text {idx.r_text_len/1e6:.1f}M local-pattern chars); "
        f"peak RSS {rss_gb():.2f}GB = {rss_gb()*1e9/GENOME_LEN:.1f} B/base")
    if SAVE_PREFIX:
        from salt_tpu.index.store import save_index

        t0 = time.time()
        save_index(idx, SAVE_PREFIX)
        sz = sum(os.path.getsize(os.path.join(d, f))
                 for d, _s, fs in os.walk(os.path.dirname(SAVE_PREFIX) or ".")
                 for f in fs if f.startswith(os.path.basename(SAVE_PREFIX)))
        log(f"saved to {SAVE_PREFIX} in {time.time()-t0:.1f}s "
            f"({sz/1e9:.2f}GB)")
    if BUILD_ONLY:
        sys.exit(0)

# reads from the SNP-mutated haplotype: both strands, 0.1% errors,
# optionally one small indel per read (--read-indels), truth encoded
# wgsim-style in the name (contig_left_right_; 1-based ref span) so
# the output scores under the bundled alneval 20bp per-MAPQ protocol
# (in load mode codes IS idx.pac — copy before mutating)
hap = codes.copy() if LOAD_PREFIX else codes
hap[gpos] = alt
del alt, gpos
reads = []
names = []
starts = []


def _mk_se_reads(idx_contigs):
    offs = [(c.offset, c.name, c.length) for c in idx_contigs]
    n_made = 0
    while n_made < N_READS:
        s = int(rng.integers(0, GENOME_LEN - L - 8))
        span = L
        r = hap[s : s + L + 8].copy()
        if (r >= 4).any():
            continue  # N run (full window: a deletion consumes the pad)
        if READ_INDEL_FRAC > 0 and rng.random() < READ_INDEL_FRAC:
            ilen = int(rng.integers(1, 5))
            p = int(rng.integers(8, L - 8))
            if rng.random() < 0.5:    # deletion: ref span longer
                r = np.concatenate([r[:p], r[p + ilen:]])
                span = L + ilen
            else:                     # insertion into the read
                ins = rng.integers(0, 4, ilen).astype(np.uint8)
                r = np.concatenate([r[:p], ins, r[p:]])
                span = L - ilen
        r = r[:L].copy()
        err = rng.random(L) < 0.001
        r[err] = rng.integers(0, 4, int(err.sum()))
        strand = int(rng.random() < 0.5)
        if strand:
            rr = r[::-1]
            r = np.where(rr < 4, 3 - rr, 4).astype(np.uint8)
        co, cn = 0, "chr1"
        for o, nm, ln in offs:
            if o <= s < o + ln:
                co, cn = o, nm
        reads.append(lut[np.minimum(r, 4)].tobytes().decode("latin1"))
        names.append(f"{cn}_{s - co + 1}_{s - co + span}_{n_made}")
        starts.append(s)
        n_made += 1


_mk_se_reads(idx.contigs)
if "--pe" not in sys.argv:
    del hap
del codes
recs = [SeqRecord(name=names[i], comment=None, seq=s, qual="I" * L)
        for i, s in enumerate(reads)]
opts = SEOptions(l_overlap=1, max_locate=500, batch_size=BATCH,
                 gap_batch=128, sa_mode=SA_MODE)
t0 = time.time()
al = SEAligner(idx, opts)
log(f"device index loaded in {time.time()-t0:.1f}s (sa_mode={SA_MODE})")
t0 = time.time()
out1 = al.align_records(recs[:BATCH])
log(f"warmup batch {time.time()-t0:.1f}s")
t0 = time.time()
out = al.align_records(recs[BATCH:])
dt = time.time() - t0
n = len(recs) - BATCH
log(f"aligned {n} reads in {dt:.2f}s -> {n/dt:.0f} reads/s")

# accuracy A: primary contig+position within 5bp of truth (round-4
# continuity metric; forward-strand left endpoints)
offs = {c.name: c.offset for c in idx.contigs}
ok = 0
tot = 0
for i, line in enumerate(out):
    if not line:
        continue
    f = line.split("\t")
    if f[2] == "*":
        continue
    tot += 1
    parts = recs[BATCH + i].name.split("_")
    truth = offs[parts[0]] + int(parts[1]) - 1
    if abs(offs[f[2]] + int(f[3]) - 1 - truth) <= 5:
        ok += 1
log(f"accuracy: {ok}/{tot} primaries within 5bp of truth "
    f"({100.0*ok/max(tot,1):.2f}%), {n - tot} unmapped")

# accuracy B: the bundled alneval protocol (wgsim_eval.pl port): 20bp
# tolerance, strand-aware endpoints, per-MAPQ error table
from salt_tpu.eval import alneval

ev = alneval(line + "\n" for line in out if line)
log("SE per-MAPQ (alneval, 20bp):\n" + ev.report())

if "--pe" in sys.argv:
    # PE pairs/s on the same genome (the BASELINE north-star metric is
    # whole-genome PE reads/s/chip): proper-orientation pairs with
    # insert ~N(500, 50) drawn from the mutated haplotype
    from salt_tpu.pipeline.pe_engine import PEAligner, PEOptions

    # the PE engine builds its own device index — release the SE
    # engine's first or a whole-genome index is resident TWICE (16GB
    # chip, ~12GB each: instant ResourceExhausted)
    import gc

    del al, out1, out
    gc.collect()
    log("SE engine released")

    n_pairs = BATCH * 2
    poffs = [(c.offset, c.name, c.length) for c in idx.contigs]
    r1l, r2l, pnames = [], [], []
    while len(r1l) < n_pairs + BATCH // 2:
        s = int(rng.integers(0, GENOME_LEN - 700))
        d = int(np.clip(rng.normal(500, 50), 2 * L + 10, 680))
        a = hap[s : s + L]
        bsrc = hap[s + d - L : s + d]
        if (a >= 4).any() or (bsrc >= 4).any():
            continue  # N run
        b = np.where(bsrc[::-1] < 4, 3 - bsrc[::-1], 4).astype(np.uint8)
        co, cn = 0, "chr1"
        for o, nm, ln in poffs:
            if o <= s < o + ln:
                co, cn = o, nm
        r1l.append(lut[a].tobytes().decode("latin1"))
        r2l.append(lut[b].tobytes().decode("latin1"))
        pnames.append(f"{cn}_{s - co + 1}_{s - co + d}_{len(pnames)}")
    mk = lambda rs: [SeqRecord(name=pnames[i], comment=None, seq=s,
                               qual="I" * L) for i, s in enumerate(rs)]
    pr1, pr2 = mk(r1l), mk(r2l)
    opts_pe = PEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                        print_xa_cigar=True, batch_size=BATCH,
                        gap_batch=128, sa_mode=SA_MODE,
                        min_tlen=350, max_tlen=650)
    al_pe = PEAligner(idx, opts_pe)
    t0 = time.time()
    al_pe.align_pairs(pr1[: BATCH // 2], pr2[: BATCH // 2])  # warmup
    log(f"PE warmup {time.time()-t0:.1f}s")
    t0 = time.time()
    pe_out = al_pe.align_pairs(pr1[BATCH // 2 :], pr2[BATCH // 2 :])
    dt = time.time() - t0
    log(f"PE: {n_pairs} pairs in {dt:.2f}s -> {n_pairs/dt:.0f} pairs/s")
    ev = alneval(line for line in pe_out if line.strip())
    log("PE per-MAPQ (alneval, 20bp):\n" + ev.report())
