#!/usr/bin/env python3
"""End-to-end smoke test of salt_tpu on NVIDIA GPUs.

One process drives the user entry points (`salt_tpu.cli.main`) on a
chromosome-scale fixture made from seeds: a repeat-rich genome (45 Mb by
default) in 8 contigs with one known SNP per 300 bp, and wgsim-style
100 bp reads drawn from the SNP haplotype at wgsim's default error,
mutation and indel rates (65,536 SE reads, 32,768 pairs, insert 500+-50).

    python chip_smoke.py                  # one GPU
    python chip_smoke.py --four           # index sharded over four GPUs
    python chip_smoke.py --trace DIR      # also write a profiler trace

One-GPU phases: device check, native helper library, fixture, `idx`,
`aln` SE / PE / sampled-SA SE / -X 1 SE, byte-exact comparison of a
subset with the CPU backend, proof that gapped LV, device SW and host
SSW each ran, and timed windows (informational; the PE windows
alternate the device SW rescue pre-filter off and on).  `--four` runs
only the sharded path (`idx --shards 4`, `aln --shards 4`) and what it
is compared with, read by read: the one-GPU monolithic run, and for the
reads whose alignment sharding may change by design, the same sharded
path on 4 virtual CPU devices.

Every comparison is exact: all device arithmetic is integer.  Any
failure exits non-zero and prints no result; a passing run ends with one
JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 8192
SE_READS = 65536         # SE reads = read 1 of the simulated pairs
PE_PAIRS = 32768
CPU_SE_READS = 2048      # re-aligned on the CPU backend for byte parity
CPU_PE_PAIRS = 1024
FOUR_SE_READS = 16384
FOUR_PE_PAIRS = 8192
CPU_BATCH = 2048         # batch of the CPU-backend re-alignments
PE_ROUNDS = 5            # alternating PE windows, device SW off / on
TLEN = ["-a", "350", "-b", "650"]   # insert 500 +- 50 (3 sd)
ALN = ["-d", "-c", "--batch-size", str(BATCH)]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"[smoke] ok: {what}", flush=True)


def device_check(n_needed: int):
    from salt_tpu.utils.device import require_gpu

    devs, cards = require_gpu(n_needed)
    print(f"[smoke] jax: {len(devs)} x {devs[0].platform} "
          f"{devs[0].device_kind}", flush=True)
    for c in cards:
        print(f"[smoke] card: {c}", flush=True)
    return devs, cards[0]


# ------------------------------------------------------------- fixture


def make_fixture(wd: str, genome_bp: int, n_pairs: int, seed: int = 7):
    """Genome FASTA + hapmap SNP file + wgsim reads, all from `seed`."""
    import numpy as np

    from salt_tpu.sim.genome_gen import (sample_snps, synthesize_genome,
                                         write_fasta)
    from salt_tpu.sim.wgsim import SimParams, simulate

    t0 = time.perf_counter()
    contigs = synthesize_genome(genome_bp, n_contigs=8, seed=seed,
                                config="repeat")
    rng = np.random.default_rng(seed)
    acgt = "ACGT"
    hap, n_snp = [], 0
    f = {k: os.path.join(wd, k) for k in
         ("genome.fa", "hap.fa", "snp.txt", "r1.fq", "r2.fq")}
    with open(f["snp.txt"], "w") as fh:
        for name, codes in contigs:
            gpos, alt, _ = sample_snps(codes, 300, rng)
            ref = codes[gpos]
            fh.writelines(
                f"{name}\t{p + 1}\t{acgt[min(r, a)]}/{acgt[max(r, a)]}\t"
                f"{acgt[r]}\n"
                for p, r, a in zip(gpos.tolist(), ref.tolist(),
                                   alt.tolist()))
            h = codes.copy()
            h[gpos] = alt
            hap.append((name, h))
            n_snp += len(gpos)
    write_fasta(contigs, f["genome.fa"])
    write_fasta(hap, f["hap.fa"])
    with open(f["r1.fq"], "w") as o1, open(f["r2.fq"], "w") as o2, \
            open(os.devnull, "w") as mut:
        n = simulate(f["hap.fa"], o1, o2, SimParams(
            dist=500, std_dev=50, n_pairs=n_pairs, size_l=100, size_r=100,
            seed=seed), mut_out=mut)
    print(f"[smoke] fixture: {genome_bp} bp genome in 8 contigs, {n_snp} "
          f"SNPs, {n} pairs in {time.perf_counter() - t0:.1f} s", flush=True)
    return f


def head_fastq(src: str, dst: str, n: int) -> str:
    with open(src) as fi, open(dst, "w") as fo:
        for i, line in enumerate(fi):
            if i >= 4 * n:
                break
            fo.write(line)
    return dst


# ------------------------------------------------------------- helpers


def cli(args, out_path=None) -> float:
    """salt_tpu.cli.main in this process; stdout to `out_path`."""
    from salt_tpu.cli import main

    t0 = time.perf_counter()
    with contextlib.ExitStack() as st:
        if out_path is not None:
            st.enter_context(contextlib.redirect_stdout(
                st.enter_context(open(out_path, "w"))))
        rc = main(args)
    if rc not in (0, None):
        raise SmokeFailure(f"cli {args[0]} returned {rc}")
    return time.perf_counter() - t0


def sam_body(path: str):
    """SAM records without the header.  SE keeps the reference's blank
    line for a skipped read; PE records are followed by a blank line."""
    with open(path) as fh:
        return [l.rstrip("\n") for l in fh if not l.startswith("@")]


def as_lines(out):
    """The lines the CLI prints for aligner output `out`."""
    return "".join(rec + "\n" for rec in out).splitlines()


class CompileLog:
    """Backend compiles seen by this process, by program name."""

    def __init__(self):
        import jax

        self.events = []
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.events.append((kw.get("fun_name", "?"), secs))

    def report(self, card):
        tot = {}
        for name, secs in self.events:
            n, s = tot.get(name, (0, 0.0))
            tot[name] = (n + 1, s + secs)
        for name, (n, s) in sorted(tot.items(), key=lambda kv: -kv[1][1]):
            print(f"[smoke] compile: {name} x{n} {s:.2f} s [{card}]")
        print(f"[smoke] compile total: {len(self.events)} programs "
              f"{sum(s for _, s in self.events):.2f} s [{card}]", flush=True)


def records(path: str):
    from salt_tpu.io.fasta import read_records

    return list(read_records(path))


def timed(fn, compiles: CompileLog):
    """(result, seconds, compiles inside the window)."""
    n0 = len(compiles.events)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, len(compiles.events) - n0


# ------------------------------------------------------------ one GPU


def run_one(args, wd: str) -> None:
    import jax

    from salt_tpu.eval import alneval
    from salt_tpu.index.store import load_index
    from salt_tpu.pipeline.engine import SEAligner, SEOptions
    from salt_tpu.pipeline.pe_engine import PEAligner, PEOptions
    from salt_tpu.utils.metrics import counts, metrics_report, metrics_reset
    from salt_tpu.utils.native import load_native

    devs, card = device_check(1)
    compiles = CompileLog()
    check(load_native() is not None, "native helper library loaded")

    fx = make_fixture(wd, int(args.genome_mb * 1_000_000), SE_READS)
    se_fq = fx["r1.fq"]
    pe1 = head_fastq(fx["r1.fq"], os.path.join(wd, "p1.fq"), PE_PAIRS)
    pe2 = head_fastq(fx["r2.fq"], os.path.join(wd, "p2.fq"), PE_PAIRS)
    prefix = os.path.join(wd, "idx")
    sam = {k: os.path.join(wd, k + ".sam") for k in
           ("se", "pe", "sampled", "x1", "cpu_se", "cpu_pe")}

    t_idx = cli(["idx", "-k", "19", fx["genome.fa"], fx["snp.txt"], prefix])
    print(f"[smoke] idx (host build + save): {t_idx:.1f} s", flush=True)

    c0 = counts()
    t_se = cli(["aln", *ALN, prefix, se_fq], sam["se"])
    c1 = counts()
    t_pe = cli(["aln", "-p", *TLEN, *ALN, prefix, pe1, pe2], sam["pe"])
    c2 = counts()
    t_sa = cli(["aln", "--sa-mode", "sampled", *ALN, prefix, se_fq],
               sam["sampled"])
    c3 = counts()
    t_x1 = cli(["aln", "-X", "1", *ALN, prefix, se_fq], sam["x1"])
    c4 = counts()
    print(f"[smoke] cli aln wall (load + residency + compile + align): "
          f"SE {t_se:.1f} s, PE {t_pe:.1f} s, sampled SE {t_sa:.1f} s, "
          f"-X 1 SE {t_x1:.1f} s [{card}]", flush=True)

    def delta(a, b, k):
        return b.get(k, 0) - a.get(k, 0)

    n_lv = delta(c0, c1, "lv.reads")
    n_ext = delta(c3, c4, "sw.device.extend")
    n_ssw = delta(c1, c2, "ssw.host") + delta(c3, c4, "ssw.host")
    print(f"[smoke] paths: {n_lv} SE reads reached gapped LV; {n_ext} -X 1 "
          f"windows scored on the device; {n_ssw} host SSW calls (PE "
          f"rescue stays on the host under device_sw=auto)", flush=True)
    check(n_lv > 0, "gapped LV ran")
    check(n_ext > 0, "device SW scored -X 1 windows")
    check(n_ssw > 0, "host SSW ran")

    se_body, pe_body = sam_body(sam["se"]), sam_body(sam["pe"])
    check(len(se_body) == SE_READS, f"SE SAM has {SE_READS} records")
    check(len(pe_body) == 4 * PE_PAIRS, f"PE SAM has {2 * PE_PAIRS} records")
    check(sam_body(sam["sampled"]) == se_body,
          "sampled-SA SE SAM == full-SA SE SAM")
    for tag, body in (("SE", se_body), ("PE", pe_body),
                      ("-X 1 SE", sam_body(sam["x1"]))):
        ev = alneval(line + "\n" for line in body if line)
        print(f"[smoke] alneval {tag}: mapped {ev.n_mapped} wrong "
              f"{ev.n_wrong}", flush=True)

    # the same reads on the CPU backend, in this process
    cpu_se = head_fastq(se_fq, os.path.join(wd, "cpu_se.fq"), CPU_SE_READS)
    cpu1 = head_fastq(pe1, os.path.join(wd, "cpu1.fq"), CPU_PE_PAIRS)
    cpu2 = head_fastq(pe2, os.path.join(wd, "cpu2.fq"), CPU_PE_PAIRS)
    cpu_aln = ["-d", "-c", "--batch-size", str(CPU_BATCH)]
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        cli(["aln", *cpu_aln, prefix, cpu_se], sam["cpu_se"])
        cli(["aln", "-p", *TLEN, *cpu_aln, prefix, cpu1, cpu2], sam["cpu_pe"])
    print(f"[smoke] CPU backend re-alignment: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(sam_body(sam["cpu_se"]) == se_body[:CPU_SE_READS],
          f"GPU SE SAM == CPU SE SAM on the first {CPU_SE_READS} reads")
    check(sam_body(sam["cpu_pe"]) == pe_body[:4 * CPU_PE_PAIRS],
          f"GPU PE SAM == CPU PE SAM on the first {CPU_PE_PAIRS} pairs")

    # timed windows through the library entry points, on the reads the
    # CLI runs above already compiled for (so the windows compile nothing)
    idx = load_index(prefix)
    se_recs = records(se_fq)
    r1, r2 = records(pe1), records(pe2)
    se_opts = SEOptions(l_overlap=idx.l_seed, print_nm_md=True,
                        print_xa_cigar=True, batch_size=BATCH)
    pe_opts = PEOptions(l_overlap=idx.l_seed, print_nm_md=True,
                        print_xa_cigar=True, batch_size=BATCH,
                        min_tlen=350, max_tlen=650)
    x1_opts = dataclasses.replace(se_opts, extend_algo="sw")

    t0 = time.perf_counter()
    al = SEAligner(idx, se_opts)
    jax.block_until_ready(al.dix)
    print(f"[smoke] device residency: {time.perf_counter() - t0:.2f} s "
          f"[{card}]", flush=True)
    pe_off = PEAligner(idx, pe_opts)            # auto: host SSW rescue
    pe_on = PEAligner(idx, dataclasses.replace(pe_opts, device_sw="on"))
    # the CLI's PE run kept rescue on the host: compile the pre-filter's
    # shapes outside the timed windows
    c0 = counts()
    check(as_lines(pe_on.align_pairs(r1, r2)) == pe_body,
          "PE SAM with device_sw=on == CLI SAM (host rescue)")
    n_rescue = delta(c0, counts(), "sw.device.rescue")
    print(f"[smoke] paths: {n_rescue} PE rescue windows scored on the "
          f"device with device_sw=on", flush=True)
    check(n_rescue > 0, "device SW scored PE rescue windows")
    # the PE rescue pre-filter alternates off / on, so drift between
    # windows does not land on one side
    pe_windows = [w for _ in range(PE_ROUNDS) for w in (
        ("PE device_sw=auto (host rescue)", pe_off),
        ("PE device_sw=on", pe_on))]
    windows = (
        [("SE", al, lambda a: a.align_records(se_recs), se_body,
          len(se_recs))]
        + [(tag, a, lambda a: a.align_pairs(r1, r2), pe_body, len(r1))
           for tag, a in pe_windows]
        + [("-X 1 SE", SEAligner(idx, x1_opts),
            lambda a: a.align_records(se_recs), sam_body(sam["x1"]),
            len(se_recs)),
           ("-X 1 SE device_sw=off",
            SEAligner(idx, dataclasses.replace(x1_opts, device_sw="off")),
            lambda a: a.align_records(se_recs), sam_body(sam["x1"]),
            len(se_recs))])
    rates = {}
    for tag, aligner, fn, want, n in windows:
        metrics_reset()
        c0 = counts()
        out, secs, n_comp = timed(lambda: fn(aligner), compiles)
        n_dev = (delta(c0, counts(), "sw.device.rescue")
                 + delta(c0, counts(), "sw.device.extend"))
        unit = "pairs/s" if tag.startswith("PE") else "reads/s"
        rates.setdefault(tag, []).append(n / secs)
        print(f"[smoke] window {tag}: {n} in {secs:.3f} s = "
              f"{n / secs:.1f} {unit}, {n_dev} windows scored by device SW, "
              f"{n_comp} compiles [{card}]", flush=True)
        for line in metrics_report(out=io.StringIO()).splitlines():
            print(f"[smoke]   {line}")
        check(as_lines(out) == want, f"{tag} window SAM == CLI SAM")
        check(n_comp == 0, f"no compiles inside the {tag} window")
    off, on = (rates[tag] for tag, _ in pe_windows[:2])
    print(f"[smoke] PE device_sw on / off, {PE_ROUNDS} alternating rounds: "
          + ", ".join(f"{b / a:.4f}" for a, b in zip(off, on))
          + f" [{card}]", flush=True)

    if args.trace:
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0      # keep the host's own cost low
        with jax.profiler.trace(args.trace, profiler_options=opts):
            al.align_records(se_recs[:2 * BATCH])
            pe_on.align_pairs(r1[:BATCH], r2[:BATCH])
        print(f"[smoke] profiler trace of 2 SE + 2 PE batches in "
              f"{args.trace}", flush=True)

    compiles.report(card)
    peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    print(f"[smoke] peak_bytes_in_use: {peak} [{card}]", flush=True)


# ---------------------------------------------------------- four GPUs


def repetitive_reads(prefix: str, fastq: str):
    """Per read: does a seed of either strand occur more than max_seed
    times in the genome?  Only such reads may align differently against
    an index sharded by reference bin, because the reference's
    occurrence-driven rules (greedy seed extension, locate caps, R-seed
    subsampling) see one shard's occurrence count there, not the
    genome's.  For every other read the sharded merge is exact."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from salt_tpu.constants import DEFAULT_MAX_SEED
    from salt_tpu.index.store import load_index
    from salt_tpu.ops.seed import seed_overlap
    from salt_tpu.pipeline.device_index import to_device_index
    from salt_tpu.pipeline.engine import encode_reads, revcomp

    idx = load_index(prefix)
    dix = to_device_index(idx)
    codes = encode_reads([r.seq for r in records(fastq)])

    @partial(jax.jit, static_argnames=("l_seed",))
    def widest(seq, l_seed):
        seeds = seed_overlap(dix.ri_c, dix.ri_r, dix.lkt, seq, l_seed,
                             l_seed, 2**30, r_lkt_sp=dix.r_lkt_sp,
                             r_lkt_ep=dix.r_lkt_ep)
        return jnp.max(jnp.stack([
            jnp.where(sd.valid, sd.ep - sd.sp + 1, 0) for sd in seeds]),
            axis=(0, 2))

    out = []
    for s0 in range(0, len(codes), BATCH):
        c = codes[s0 : s0 + BATCH]
        w = widest(jnp.asarray(np.concatenate([c, revcomp(c)]), jnp.int32),
                   l_seed=idx.l_seed)
        w = np.asarray(w).reshape(2, -1).max(axis=0)
        out.append(w > DEFAULT_MAX_SEED)
    return np.concatenate(out)


def sharded_on_cpu(prefix: str):
    """SE and PE aligners over the same sharded index, on a mesh of 4
    virtual CPU devices: the plain backend of the sharded path."""
    import json

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from salt_tpu.index.store import load_index
    from salt_tpu.parallel.sharded_engine import (ShardedPEAligner,
                                                  ShardedSEAligner)
    from salt_tpu.pipeline.engine import SEOptions
    from salt_tpu.pipeline.pe_engine import PEOptions

    idx = load_index(prefix)
    with open(prefix + ".shards.json") as fh:
        man = json.load(fh)
    shards = [load_index(f"{prefix}.shard{i}")
              for i in range(man["n_shards"])]
    kw = dict(mesh=Mesh(np.array(jax.devices("cpu")[:4]), ("shard",)),
              bins=man["bins"],
              contig_lengths=[c.length for c in idx.contigs])
    se = ShardedSEAligner(idx, shards, SEOptions(
        l_overlap=idx.l_seed, print_nm_md=True, print_xa_cigar=True,
        batch_size=CPU_BATCH), **kw)
    pe = ShardedPEAligner(idx, shards, PEOptions(
        l_overlap=idx.l_seed, print_nm_md=True, print_xa_cigar=True,
        batch_size=CPU_BATCH, min_tlen=350, max_tlen=650), **kw)
    return se, pe


def run_four(args, wd: str) -> None:
    import jax
    import numpy as np

    devs, card = device_check(4)
    fx = make_fixture(wd, int(args.genome_mb * 1_000_000), FOUR_SE_READS)
    se_fq = fx["r1.fq"]
    pe1 = head_fastq(fx["r1.fq"], os.path.join(wd, "p1.fq"), FOUR_PE_PAIRS)
    pe2 = head_fastq(fx["r2.fq"], os.path.join(wd, "p2.fq"), FOUR_PE_PAIRS)
    prefix = os.path.join(wd, "idx")
    t_idx = cli(["idx", "-k", "19", "--shards", "4", fx["genome.fa"],
                 fx["snp.txt"], prefix])
    print(f"[smoke] idx + 4 shards (host build + save): {t_idx:.1f} s",
          flush=True)
    sam = {}
    for mode, extra in (("sharded", ["--shards", "4"]), ("mono", [])):
        for end, ends in (("se", [se_fq]), ("pe", [pe1, pe2])):
            out = sam[mode, end] = os.path.join(wd, f"{mode}_{end}.sam")
            pe = ["-p", *TLEN] if end == "pe" else []
            secs = cli(["aln", *pe, *extra, *ALN, prefix, *ends], out)
            print(f"[smoke] {mode} {end}: {secs:.1f} s [{card}]", flush=True)
    # Every read is compared.  A read none of whose seeds occurs more
    # than max_seed times must equal the monolithic run; the others may
    # differ from it by design (see repetitive_reads), so they must equal
    # the same sharded path run on the plain backend: 4 CPU devices.
    rep_se = repetitive_reads(prefix, se_fq)
    rep_pe = repetitive_reads(prefix, pe1) | repetitive_reads(prefix, pe2)
    se_recs, r1, r2 = records(se_fq), records(pe1), records(pe2)
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_se, cpu_pe = sharded_on_cpu(prefix)
        cpu_out = {
            "se": cpu_se.align_records(
                [se_recs[i] for i in np.nonzero(rep_se)[0]]),
            "pe": cpu_pe.align_pairs(
                [r1[i] for i in np.nonzero(rep_pe)[0]],
                [r2[i] for i in np.nonzero(rep_pe)[0]])}
    print(f"[smoke] sharded path on 4 CPU devices, repetitive reads only: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for end, rep, per in (("se", rep_se, 1), ("pe", rep_pe, 4)):
        what = "pairs" if per == 4 else "reads"
        a, b = sam_body(sam["sharded", end]), sam_body(sam["mono", end])
        check(len(a) == len(b) == per * len(rep),
              f"{end.upper()} SAMs have {len(rep)} {what}")
        rows = [(a[i * per : (i + 1) * per], b[i * per : (i + 1) * per])
                for i in range(len(rep))]
        differ = [i for i, (x, y) in enumerate(rows) if x != y]
        print(f"[smoke] {end.upper()}: {int(rep.sum())} of {len(rep)} "
              f"{what} with a seed occurring > max_seed times; sharded != "
              f"monolithic on {len(differ)}: "
              + " ".join(a[i * per].split("\t")[0] for i in differ),
              flush=True)
        check(all(rep[i] for i in differ),
              f"4-GPU sharded {end.upper()} SAM == 1-GPU monolithic SAM on "
              f"every one of the {int((~rep).sum())} other {what}")
        check(as_lines(cpu_out[end])
              == [ln for i in np.nonzero(rep)[0] for ln in rows[i][0]],
              f"4-GPU sharded {end.upper()} SAM == sharded on 4 CPU "
              f"devices on every one of the {int(rep.sum())} repetitive "
              f"{what}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs[:4]]
    for d, p in zip(devs[:4], peaks):
        print(f"[smoke] {d} peak_bytes_in_use: {p} [{card}]", flush=True)
    check(min(peaks) >= 16 << 20, "every one of the 4 devices held >= 16 MiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded-index path")
    ap.add_argument("--genome-mb", type=float, default=45.0)
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a jax.profiler trace of a short window")
    args = ap.parse_args(argv)

    if args.four:
        # 4 virtual CPU devices beside the GPUs, for the sharded path's
        # plain backend; read when JAX first starts its CPU client
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")
    import jax

    with tempfile.TemporaryDirectory(prefix="salt_smoke_") as wd:
        (run_four if args.four else run_one)(args, wd)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
