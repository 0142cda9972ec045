"""Sharded engine, full-cap overflow rows that also need the gapped
check: the re-run's loci are indexed by their row in the re-run
sub-batch, the reads by their row in the batch.  With the overflow read
deep in the batch the two differ, and the sharded SAM must still equal
the monolithic SAM."""

import numpy as np

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.fasta import SeqRecord
from salt_tpu.io.snp import SnpBlock
from salt_tpu.parallel.sharded_engine import build_sharded_se
from salt_tpu.pipeline.engine import SEAligner, SEOptions

RL = 100


def test_overflow_gapped_rows_use_their_own_reads():
    rng = np.random.default_rng(5)
    bases = "ACGT"
    unit = [bases[c] for c in rng.integers(0, 4, 160)]
    contigs, blocks = [], []
    for ci in range(2):
        seq = [bases[c] for c in rng.integers(0, 4, 6000)]
        for at in (500, 2000, 3500):      # 3 copies per contig
            seq[at : at + 160] = unit
        contigs.append((f"chr{ci}", "syn", "".join(seq)))
        blocks.append(SnpBlock(f"chr{ci}", np.zeros(0, np.uint32),
                               np.zeros(0, np.uint8)))
    reads = []
    for i in range(16):
        ci = i % 2
        seq = contigs[ci][2]
        if i % 4 == 3:                     # repeat read, 5 mismatches:
            r = list(seq[2030 : 2030 + RL])  # overflow + gapped LV
            for p in (10, 30, 50, 70, 90):
                r[p] = bases[(bases.index(r[p]) + 1) % 4]
        else:                              # unique read
            s = 4000 + 60 * i
            r = list(seq[s : s + RL])
        reads.append(SeqRecord(name=f"r{i}", comment=None, seq="".join(r),
                               qual="I" * RL))
    opts = SEOptions(l_overlap=1, max_locate=500, batch_size=16,
                     gap_batch=4, verify_width=2)
    mono = SEAligner(build_index_from_data(contigs, blocks, l_seed=19),
                     opts)
    sharded = build_sharded_se(contigs, blocks, 2, opts=opts, l_seed=19)
    want = mono.align_records(reads)
    got = sharded.align_records(reads)
    assert sum(1 for line in want if line.split("\t")[2] != "*") == 16
    assert got == want
