"""Benchmark: one-GPU SE and PE alignment throughput on a seeded fixture.

The fixture is made from seeds, with no external files: a 100 kb
genome with a 5% SNP overlay, 100 bp reads drawn from the SNP haplotype
(SE), FR pairs (PE), and a 45 Mb repeat-rich genome with one SNP per
300 bp (scale phase).  Every phase always runs; any failure exits
non-zero.  Each number is printed with the platform, device kind, device
count and the card's power limit; the last line is one JSON object.

    python bench.py

The timed windows are short (one to three batches) and the three
fixtures differ in genome size and read errors, so the rates are not
comparable with one another or with the C reference's throughput.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GENOME_BP = 100_000
READ_LEN = 100
N_READS = 24576
BATCH = 8192


def make_fixture():
    """Seeded genome, SNP table and SE reads from the mutated haplotype."""
    from salt_tpu.io.snp import SnpBlock
    from salt_tpu.sim.genome_gen import synthesize_genome

    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    (name, codes), = synthesize_genome(GENOME_BP, 1, seed=42,
                                       config="uniform")
    seq = lut[codes].tobytes().decode("latin1")
    contigs = [(name, "synthetic", seq)]
    rng = np.random.default_rng(42)
    bases = "ACGT"
    blocks = []
    mutated = []
    for name, _, seq in contigs:
        L = len(seq)
        n_snp = int(L * 0.05)
        pos = np.sort(rng.choice(np.arange(L), size=n_snp, replace=False))
        stype = []
        mseq = list(seq)
        keep_pos = []
        for p in pos:
            c = seq[p].upper()
            if c not in bases:
                continue
            ref = bases.index(c)
            alt = (ref + int(rng.integers(1, 4))) % 4
            stype.append((1 << ref) | (1 << alt) | (ref << 4))
            mseq[p] = bases[alt]
            keep_pos.append(p)
        blocks.append(
            SnpBlock(name, np.array(keep_pos, np.uint32), np.array(stype, np.uint8))
        )
        mutated.append("".join(mseq))
    reads = []
    for _ in range(N_READS):
        ci = int(rng.integers(0, len(mutated)))
        hap = mutated[ci]
        start = int(rng.integers(0, len(hap) - READ_LEN))
        reads.append(hap[start : start + READ_LEN])
    return contigs, blocks, reads


def make_pe_fixture(contigs, blocks, n_pairs, isize=450, sd=30):
    """PE read pairs (FR orientation) from the SNP haplotypes."""
    rng = np.random.default_rng(1234)
    bases = "ACGT"
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    haps = []
    for (name, _, seq), blk in zip(contigs, blocks):
        h = list(seq.upper())
        for p, st in zip(blk.pos, blk.stype):
            alts = [b for b in range(4) if (st & (1 << b)) and b != (st >> 4)]
            if alts:
                h[p] = bases[alts[0]]
        haps.append("".join(h))
    r1, r2 = [], []
    for _ in range(n_pairs):
        ci = int(rng.integers(0, len(haps)))
        hap = haps[ci]
        tl = int(np.clip(rng.normal(isize, sd), READ_LEN + 10, 640))
        if len(hap) < tl + 2:
            continue
        s = int(rng.integers(0, len(hap) - tl))
        fwd = hap[s : s + READ_LEN]
        mate = hap[s + tl - READ_LEN : s + tl]
        rev = "".join(comp.get(c, "N") for c in reversed(mate))
        r1.append(fwd)
        r2.append(rev)
    return r1, r2


def _records(seqs, tag):
    from salt_tpu.io.fasta import SeqRecord

    return [SeqRecord(name=f"{tag}{i}", comment=None, seq=s,
                      qual="I" * len(s)) for i, s in enumerate(seqs)]


def run_se(idx, reads):
    """SE reads/s after a one-batch warmup."""
    from salt_tpu.pipeline.engine import SEAligner, SEOptions

    al = SEAligner(idx, SEOptions(
        l_overlap=1, max_locate=500, print_nm_md=True, print_xa_cigar=True,
        batch_size=BATCH, gap_batch=128))
    recs = _records(reads, "r")
    al.align_records(recs[:BATCH])       # warmup: compile + residency
    t0 = time.perf_counter()
    out = al.align_records(recs[BATCH:])
    dt = time.perf_counter() - t0
    mapped = sum(1 for line in out if line and line.split("\t")[2] != "*")
    sys.stderr.write(f"[bench] SE: {len(out)} reads in {dt:.2f} s, "
                     f"{mapped} mapped\n")
    return len(out) / dt


def run_pe(contigs, blocks, idx):
    """PE pairs/s after a one-batch warmup."""
    from salt_tpu.pipeline.pe_engine import PEAligner, PEOptions

    n_pairs = 2 * BATCH
    r1, r2 = make_pe_fixture(contigs, blocks, n_pairs + BATCH)
    al = PEAligner(idx, PEOptions(
        l_overlap=1, max_locate=500, print_nm_md=True, print_xa_cigar=True,
        batch_size=BATCH, gap_batch=128))
    recs1, recs2 = _records(r1, "p"), _records(r2, "p")
    al.align_pairs(recs1[:BATCH], recs2[:BATCH])     # warmup
    t0 = time.perf_counter()
    out = al.align_pairs(recs1[BATCH:], recs2[BATCH:])
    dt = time.perf_counter() - t0
    n = len(out) // 2
    sys.stderr.write(f"[bench] PE: {n} pairs in {dt:.2f} s\n")
    return n / dt


def run_scale(genome_mb=45):
    """SE reads/s on a 45 Mb repeat-rich genome with 1/300 bp SNPs."""
    from salt_tpu.index.build import build_index_from_data
    from salt_tpu.io.snp import SnpBlock
    from salt_tpu.sim.genome_gen import sample_snps, synthesize_genome

    glen = genome_mb * 1_000_000
    rng = np.random.default_rng(77)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    (name, codes), = synthesize_genome(glen, 1, seed=7, config="repeat")
    gpos, alt, stype = sample_snps(codes, 300, rng)
    contig_data = [(name, "synthetic", lut[codes])]
    blocks = [SnpBlock(name, gpos.astype(np.uint32), stype)]
    t0 = time.perf_counter()
    idx = build_index_from_data(contig_data, blocks, l_seed=19)
    sys.stderr.write(f"[bench] scale index ({genome_mb} Mb repeat) built "
                     f"in {time.perf_counter() - t0:.1f} s\n")
    hap = codes.copy()
    hap[gpos] = alt
    reads = []
    for s in rng.integers(0, glen - READ_LEN, 3 * BATCH):
        r = hap[s : s + READ_LEN].copy()
        err = rng.random(READ_LEN) < 0.001
        r[err] = rng.integers(0, 4, int(err.sum()))
        reads.append(lut[np.minimum(r, 4)].tobytes().decode("latin1"))
    return run_se(idx, reads)


def main():
    from salt_tpu.index.build import build_index_from_data
    from salt_tpu.utils.device import require_gpu

    devs, cards = require_gpu()
    where = (f"{devs[0].platform} {devs[0].device_kind} x{len(devs)} "
             f"[{cards[0]}]")
    contigs, blocks, reads = make_fixture()
    idx = build_index_from_data(contigs, blocks, l_seed=19)
    se = run_se(idx, reads)
    pe = run_pe(contigs, blocks, idx)
    scale = run_scale()
    for what, v, unit in (("SE", se, "reads/s"), ("PE", pe, "pairs/s"),
                          ("45 Mb repeat SE", scale, "reads/s")):
        print(f"[bench] {what}: {v:.1f} {unit} on {where}")
    print(json.dumps({
        "metric": "se_reads_per_sec_per_chip",
        "value": round(se, 1),
        "unit": "reads/s",
        "pe_pairs_per_sec": round(pe, 1),
        "scale45mb_repeat_se_reads_per_sec": round(scale, 1),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs),
                   "card": cards[0]},
    }))


if __name__ == "__main__":
    main()
