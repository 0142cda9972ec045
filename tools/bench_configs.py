"""BASELINE.md measurement configs 2 and 3 on the current backend:

  config 2: E. coli-scale plain index (4.6M bases, NO SNP overlay) —
            the environment has no network, so the genome is a
            synthetic 4.6Mb random sequence (same scale/entropy as
            K-12; wgsim-style reads with 0.5% errors)
  config 3: chr21-scale SNP-aware index (45M bases + 1/300bp SNPs),
            reads drawn from the SNP-mutated haplotype

Prints one line per config: build time, load time, reads/s, accuracy.
Runs on the default JAX backend (JAX_PLATFORMS=cpu for the CPU).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.fasta import SeqRecord
from salt_tpu.io.snp import SnpBlock
from salt_tpu.pipeline.engine import SEAligner, SEOptions

BATCH = int(os.environ.get("SALT_TPU_BENCH_BATCH", "8192"))
N_BATCHES = 3
L = 100


def run_config(tag, genome_len, snp_every, err, sa_mode="full"):
    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = rng.integers(0, 4, genome_len, dtype=np.int64).astype(np.uint8)
    if snp_every:
        n_snp = genome_len // snp_every
        pos = np.sort(rng.choice(genome_len, n_snp, replace=False)
                      .astype(np.int64))
        ref_c = codes[pos]
        alt = ((ref_c + rng.integers(1, 4, n_snp)) % 4).astype(np.uint8)
        stype = ((1 << ref_c) | (1 << alt) | (ref_c << 4)).astype(np.uint8)
        blocks = [SnpBlock("chr1", pos.astype(np.uint32), stype)]
    else:
        blocks = []
    t0 = time.time()
    idx = build_index_from_data([("chr1", "synt", lut[codes])], blocks,
                                l_seed=19)
    t_build = time.time() - t0

    hap = codes.copy()
    if snp_every:
        hap[pos] = alt
    n_reads = BATCH * (N_BATCHES + 1)
    starts = rng.integers(0, genome_len - L, n_reads)
    win = hap[starts[:, None] + np.arange(L)]
    emask = rng.random(win.shape) < err
    win = np.where(emask, (win + 1) & 3, win).astype(np.uint8)
    recs = [
        SeqRecord(name=f"r{i}_{starts[i]}", comment=None,
                  seq=lut[win[i]].tobytes().decode("latin1"), qual="I" * L)
        for i in range(n_reads)
    ]

    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=BATCH, gap_batch=128,
                     sa_mode=sa_mode)
    t0 = time.time()
    al = SEAligner(idx, opts)
    t_load = time.time() - t0
    al.align_records(recs[:BATCH])           # warmup/compile
    t0 = time.time()
    out = al.align_records(recs[BATCH:])
    dt = time.time() - t0
    n = len(out)
    ok = 0
    mapped = 0
    for i, line in enumerate(out):
        f = line.split("\t")
        if f[2] == "*":
            continue
        mapped += 1
        if abs(int(f[3]) - 1 - int(starts[BATCH + i])) <= 5:
            ok += 1
    print(f"[config {tag}] build {t_build:.1f}s, device load {t_load:.1f}s, "
          f"{n}/{dt:.2f}s = {n/dt:.0f} reads/s, "
          f"{mapped}/{n} mapped, {100.0*ok/max(mapped,1):.2f}% correct",
          flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "2"):
        run_config("2: E.coli-scale plain", 4_600_000, 0, 0.005)
    if which in ("all", "3"):
        run_config("3: chr21-scale SNP-aware", 45_000_000, 300, 0.001)
    if which == "3s":
        run_config("3s: chr21-scale sampled", 45_000_000, 300, 0.001,
                   sa_mode="sampled")
