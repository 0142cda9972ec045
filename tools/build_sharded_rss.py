"""Bounded-RAM whole-genome index construction: build the index
sharded by reference bin, one shard per fresh subprocess, and measure
each shard's peak RSS.

The monolithic 3.1G build needs ~28 B/base peak (86.5GB on this host)
because the u32 SA-IS runs over the full concatenated C text — fine on
a 125GB build host, impossible on a typical 32-64GB machine.  The
reference solves this with incremental BWT construction at ~2.5
bits/char of working memory (Index_src/bwt_gen.c:1400-1538).  The
answer here is the sharded-by-bin index (SURVEY §2.6, the
sharded aligner's native format): each shard is < 2^31 chars, builds
with the i32 SA-IS at peak RSS proportional to the SHARD length, and
the shard bundles feed ShardedSEAligner/ShardedPEAligner on a device
mesh unchanged.  Byte-parity of the sharded aligner against the
monolithic one is asserted by tests/test_sharded_engine.py.

  python tools/build_sharded_rss.py [total_bases] [n_shards]

Writes the genome once to /tmp/shardbuild/genome.npy (memmap), then
builds each shard in a fresh python subprocess (so ru_maxrss is
per-shard, not a high-water mark across shards) and prints a per-shard
table: build seconds, peak RSS GB, B/base-of-shard.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TOTAL = int(sys.argv[1]) if len(sys.argv) > 1 else 3_100_000_000
N_SHARDS = int(sys.argv[2]) if len(sys.argv) > 2 else 8
WORKDIR = "/tmp/shardbuild"
SNP_EVERY = 300

CHILD = r"""
import os, resource, sys, time
sys.path.insert(0, sys.argv[4])
import numpy as np
from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.snp import SnpBlock

shard = int(sys.argv[1])
total = int(sys.argv[2])
n_shards = int(sys.argv[3])
workdir = sys.argv[5]
clen = total // n_shards
s0 = shard * clen
s1 = total if shard == n_shards - 1 else s0 + clen
genome = np.load(workdir + "/genome.npy", mmap_mode="r")
snp = np.load(workdir + "/snp.npz")
gpos, stype = snp["gpos"], snp["stype"]
lut = np.frombuffer(b"ACGTN", np.uint8)
codes = np.asarray(genome[s0:s1])          # one shard resident
sel = (gpos >= s0) & (gpos < s1)
blocks = [SnpBlock(f"chr{shard+1}", (gpos[sel] - s0).astype(np.uint32),
                   stype[sel])]
contig_data = [(f"chr{shard+1}", "synthetic", lut[np.minimum(codes, 4)])]
t0 = time.time()
idx = build_index_from_data(contig_data, blocks, l_seed=19)
dt = time.time() - t0
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
n = s1 - s0
print(f"SHARD {shard} bases {n} build_s {dt:.1f} rss_gb {rss:.2f} "
      f"b_per_base {rss*1e9/n:.1f} c_sa_len {len(idx.csa)}",
      flush=True)
"""


def main():
    os.makedirs(WORKDIR, exist_ok=True)
    gpath = f"{WORKDIR}/genome.npy"
    if not os.path.exists(gpath):
        from salt_tpu.sim.genome_gen import sample_snps, synthesize_genome

        t0 = time.time()
        # one contig per shard bin (contiguous-bin partition)
        contigs = synthesize_genome(TOTAL, N_SHARDS, seed=7,
                                    config="uniform")
        genome = np.concatenate([c for _n, c in contigs])
        np.save(gpath, genome)
        rng = np.random.default_rng(7)
        gpos, _alt, stype = sample_snps(genome, SNP_EVERY, rng)
        np.savez(f"{WORKDIR}/snp.npz", gpos=gpos, stype=stype)
        print(f"[shardbuild] genome+SNPs synthesized in "
              f"{time.time()-t0:.0f}s", flush=True)
        del genome, gpos, stype

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = []
    for shard in range(N_SHARDS):
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, "-c", CHILD, str(shard), str(TOTAL),
             str(N_SHARDS), repo, WORKDIR],
            capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        line = [l for l in out.stdout.splitlines() if l.startswith("SHARD")]
        if out.returncode != 0 or not line:
            print(f"[shardbuild] shard {shard} FAILED:\n{out.stderr[-2000:]}")
            return 1
        print(line[0], flush=True)
        results.append(line[0])
    print(f"[shardbuild] all {N_SHARDS} shards built; peak per-shard RSS "
          f"above — the whole-genome build fits any host with "
          f"~(total/{N_SHARDS})*28 bytes of RAM", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
