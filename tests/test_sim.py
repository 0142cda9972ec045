"""In-tree wgsim-compatible simulator: truth format + end-to-end
round-trip (simulate -> index -> align -> alneval) on a small genome."""

import io
import os
import re

import numpy as np
import pytest

from salt_tpu.sim.wgsim import SimParams, simulate

_NAME_RE = re.compile(r"^@(\S+)_(\d+)_(\d+)_(\d+):(\d+):(\d+)_(\d+):(\d+):(\d+)_([0-9a-f]+)/([12])$")


def _genome(tmp_path, n=9000, seed=3):
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrS\n{seq}\n")
    return fa, seq


def test_name_format_and_lengths(tmp_path):
    fa, _ = _genome(tmp_path)
    o1, o2, mut = io.StringIO(), io.StringIO(), io.StringIO()
    p = SimParams(err_rate=0.0, mut_rate=0.01, indel_frac=0.1, n_pairs=50,
                  size_l=70, size_r=70, dist=300, std_dev=30, seed=7)
    n = simulate(str(fa), o1, o2, p, mut_out=mut)
    assert n == 50
    l1 = o1.getvalue().splitlines()
    l2 = o2.getvalue().splitlines()
    assert len(l1) == len(l2) == 50 * 4
    for i in range(0, len(l1), 4):
        m = _NAME_RE.match(l1[i])
        assert m, l1[i]
        assert m.group(1) == "chrS"
        left, right = int(m.group(2)), int(m.group(3))
        assert 1 <= left < right
        assert len(l1[i + 1]) == 70
        assert l1[i + 2] == "+"
        assert len(l1[i + 3]) == 70
        # mate has the same truth coordinates, opposite end number
        m2 = _NAME_RE.match(l2[i])
        assert (m2.group(2), m2.group(3)) == (m.group(2), m.group(3))
        assert {m.group(11), m2.group(11)} == {"1", "2"}


def test_truth_table_matches_genome(tmp_path):
    fa, seq = _genome(tmp_path)
    o1, o2, mut = io.StringIO(), io.StringIO(), io.StringIO()
    p = SimParams(err_rate=0.0, mut_rate=0.02, indel_frac=0.2, n_pairs=5,
                  dist=300, std_dev=30, seed=11)
    simulate(str(fa), o1, o2, p, mut_out=mut)
    rows = [l.split("\t") for l in mut.getvalue().splitlines()]
    assert rows, "no mutations generated"
    n_sub = n_indel = 0
    for chrom, pos, ref, alt, het in rows:
        assert chrom == "chrS"
        i = int(pos) - 1
        if ref != "-":
            assert seq[i] == ref  # truth ref matches the genome
        if ref != "-" and alt != "-":
            n_sub += 1
            if het == "-":
                assert alt in "ACGT" and alt != ref
            else:
                assert alt in "MRSVWYHKDBN"  # IUPAC het code
        else:
            n_indel += 1
    assert n_sub > 0


def test_roundtrip_accuracy(tmp_path):
    """Error-free haploid reads from a SNP-mutated genome align back to
    their true positions (the run_test.sh flow in miniature)."""
    from salt_tpu.eval import alneval
    from salt_tpu.index.build import build_index_from_data
    from salt_tpu.io.fasta import SeqRecord, read_records
    from salt_tpu.io.snp import SnpBlock
    from salt_tpu.pipeline.engine import SEAligner, SEOptions

    fa, seq = _genome(tmp_path)
    o1, o2, mut = io.StringIO(), io.StringIO(), io.StringIO()
    p = SimParams(err_rate=0.0, mut_rate=0.02, indel_frac=0.0, n_pairs=60,
                  size_l=70, size_r=70, dist=300, std_dev=30,
                  is_hap=True, seed=23)
    simulate(str(fa), o1, o2, p, mut_out=mut)

    # run_test.sh:27-29: simulated substitutions become the known-SNP table
    pos, stype = [], []
    for line in mut.getvalue().splitlines():
        chrom, ppos, ref, alt, _ = line.split("\t")
        if ref == "-" or alt == "-" or alt not in "ACGT":
            continue
        pos.append(int(ppos) - 1)
        r, a = "ACGT".index(ref), "ACGT".index(alt)
        stype.append((1 << r) | (1 << a) | (r << 4))
    blk = SnpBlock("chrS", np.array(pos, np.uint32), np.array(stype, np.uint8))
    idx = build_index_from_data([("chrS", "(null)", seq)], [blk], l_seed=19)

    recs = []
    lines = o1.getvalue().splitlines()
    for i in range(0, len(lines), 4):
        recs.append(SeqRecord(name=lines[i][1:], comment=None,
                              seq=lines[i + 1], qual=lines[i + 3]))
    al = SEAligner(idx, SEOptions(l_overlap=1, max_locate=500, batch_size=64))
    out = al.align_records(recs)
    ev = alneval(out)
    assert ev.n_mapped >= 55
    assert ev.n_wrong <= 1


def test_pe_device_sw_prefilter_identical(tmp_path):
    """PEAligner output is byte-identical with the device-SW rescue
    pre-filter on vs off (the filter may only skip candidates the exact
    SSW would reject)."""
    from salt_tpu.index.build import build_index_from_data
    from salt_tpu.io.fasta import SeqRecord
    from salt_tpu.io.snp import SnpBlock
    from salt_tpu.pipeline.pe_engine import PEAligner, PEOptions

    fa, seq = _genome(tmp_path, n=12000, seed=9)
    o1, o2, mut = io.StringIO(), io.StringIO(), io.StringIO()
    # some mutations and errors so a few pairs need SW rescue
    p = SimParams(err_rate=0.01, mut_rate=0.02, indel_frac=0.1, n_pairs=80,
                  size_l=70, size_r=70, dist=300, std_dev=30,
                  is_hap=True, seed=31)
    simulate(str(fa), o1, o2, p, mut_out=mut)

    pos, stype = [], []
    for line in mut.getvalue().splitlines():
        chrom, ppos, ref, alt, _ = line.split("\t")
        if ref == "-" or alt == "-" or alt not in "ACGT":
            continue
        pos.append(int(ppos) - 1)
        r, a = "ACGT".index(ref), "ACGT".index(alt)
        stype.append((1 << r) | (1 << a) | (r << 4))
    blk = SnpBlock("chrS", np.array(pos, np.uint32), np.array(stype, np.uint8))
    idx = build_index_from_data([("chrS", "(null)", seq)], [blk], l_seed=19)

    def recs(buf):
        lines = buf.getvalue().splitlines()
        return [SeqRecord(name=lines[i][1:], comment=None, seq=lines[i + 1],
                          qual=lines[i + 3]) for i in range(0, len(lines), 4)]

    r1, r2 = recs(o1), recs(o2)
    outs = {}
    for mode in ("off", "on"):
        al = PEAligner(idx, PEOptions(
            l_overlap=1, max_locate=500, batch_size=64,
            min_tlen=200, max_tlen=420, device_sw=mode,
        ))
        outs[mode] = al.align_pairs(r1, r2)
    assert outs["off"] == outs["on"]
    mapped = sum(1 for l in outs["off"] if l.split("\t")[2] != "*")
    assert mapped >= 150  # 160 ends total


def test_exact_mode_bit_identical_to_c_wgsim(tmp_path):
    """--exact replays the C tool's drand48 sequence: R1/R2/mutations
    byte-equal for the same seed."""
    import subprocess

    from conftest import have_oracle
    import pytest

    wg = "/tmp/refbuild/Test/Simulator/wgsim-master/wgsim"
    genome = "/tmp/refbuild/Test/Genome/Genome.fa"
    if not (have_oracle() and os.path.exists(wg)):
        pytest.skip("compiled reference wgsim not present")

    from salt_tpu.sim.wgsim import SimParams, simulate_exact

    for args, p in (
        (["-S", "42", "-e", "0", "-r", "0.05", "-R", "0", "-d", "500",
          "-s", "50", "-N", "800", "-1", "100", "-2", "100", "-h"],
         SimParams(seed=42, err_rate=0, mut_rate=0.05, indel_frac=0,
                   dist=500, std_dev=50, n_pairs=800, size_l=100,
                   size_r=100, is_hap=True)),
        (["-S", "7", "-e", "0.02", "-r", "0.01", "-R", "0.15", "-X", "0.3",
          "-d", "400", "-s", "40", "-N", "600", "-1", "90", "-2", "80"],
         SimParams(seed=7, err_rate=0.02, mut_rate=0.01, indel_frac=0.15,
                   indel_extend=0.3, dist=400, std_dev=40, n_pairs=600,
                   size_l=90, size_r=80, is_hap=False)),
    ):
        c1, c2 = tmp_path / "c1.fq", tmp_path / "c2.fq"
        cm = subprocess.run([wg] + args + [genome, str(c1), str(c2)],
                            capture_output=True, text=True, check=True)
        p1, p2 = io.StringIO(), io.StringIO()
        pm = io.StringIO()
        simulate_exact(genome, p1, p2, p, mut_out=pm)
        assert p1.getvalue() == c1.read_text()
        assert p2.getvalue() == c2.read_text()
        assert pm.getvalue() == cm.stdout
