"""Command-line entry points: `salt-tpu idx`, `salt-tpu aln`.

Option surface mirrors the reference CLIs (Align_src/aln.c:102-228,
Index_src/index1.c:46-66) with the reference's defaults.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    # pass-through subcommands dispatch before argparse: REMAINDER does
    # not capture leading option flags (e.g. `wgsim -e 0 ...`)
    if argv and argv[0] == "wgsim":
        from .sim.wgsim import wgsim_main

        return wgsim_main(argv[1:])
    if argv and argv[0] == "snp-etl":
        from .etl.snp_etl import _main as etl_main

        return etl_main(argv[1:])
    if argv and argv[0] == "alneval":
        from .eval.wgsim_eval import _main as eval_main

        return eval_main(argv[1:])
    ap = argparse.ArgumentParser(prog="salt-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("idx", help="build SNP-aware index")
    ix.add_argument("-k", "--seed-len", type=int, default=25)
    ix.add_argument("--compat-rpart", action="store_true",
                    help="reproduce the reference's broken R-part anchors")
    ix.add_argument("--shards", type=int, default=0,
                    help="also build N per-reference-bin sub-indexes "
                         "(contiguous contig runs) for `aln --shards N`")
    ix.add_argument("ref_fa")
    ix.add_argument("snp_file")
    ix.add_argument("prefix")

    al = sub.add_parser("aln", help="align reads -> SAM on stdout")
    # -t is real in the reference (pthread pool, aln.c:141-143) but has
    # no analogue here: batches are data-parallel on the device and the
    # host side is single-process; a stderr note is printed when set.
    al.add_argument("-t", "--threads", type=int, default=1)
    # -n/-l are parsed by the reference but inert there too: -n feeds
    # aln_opt->max_diff which every consumer overwrites (alnse.c:990 vs
    # 1016 `max_diff = 3` and 1090 `max_diff = l_seq/10`), and -l only
    # sizes aux buffers (aux_init, alnse.c:1381) — the actual length
    # comes from the reads.  Accepted for drop-in compatibility; a
    # stderr note is printed when they differ from the defaults.
    al.add_argument("-n", "--num", type=int, default=-1)
    al.add_argument("-g", "--group", default=None)
    al.add_argument("-l", "--read-length", type=int, default=100)
    al.add_argument("-c", "--xa-cigar", action="store_true")
    al.add_argument("-d", "--md", action="store_true")
    al.add_argument("-r", "--overlap", type=int, default=-1)
    al.add_argument("-s", "--max-seed", type=int, default=50)
    al.add_argument("-m", "--max-locate", type=int, default=1000)
    al.add_argument("-p", "--pe", action="store_true")
    al.add_argument("-a", "--min-tlen", type=int, default=250)
    al.add_argument("-b", "--max-tlen", type=int, default=550)
    al.add_argument("-e", "--sw", action="store_true")
    al.add_argument("-X", "--extend", type=int, default=0,
                    help="extension algorithm: 0=Landau-Vishkin, 1=SW")
    # accepted for drop-in compatibility; parsed but dead in the
    # reference too (aln.c:183,190-196 set fields no code reads)
    al.add_argument("-v", "--ref", action="store_true",
                    help=argparse.SUPPRESS)
    al.add_argument("-M", "--mismatch", type=int, default=None,
                    help=argparse.SUPPRESS)
    al.add_argument("-O", "--gapop", type=int, default=None,
                    help=argparse.SUPPRESS)
    al.add_argument("-E", "--gapex", type=int, default=None,
                    help=argparse.SUPPRESS)
    al.add_argument("--batch-size", type=int, default=4096)
    al.add_argument("--sa-mode", choices=["full", "sampled"], default="full",
                    help="sampled: ~12x smaller locate tables (whole-human-"
                         "genome index on one chip), bounded LF-walk locate")
    al.add_argument("--shards", type=int, default=0,
                    help="align against an index sharded by reference bin "
                         "over N mesh devices (built with idx --shards N)")
    al.add_argument("--part-dir", default=None,
                    help="multi-host mode: write per-batch SAM parts here")
    al.add_argument("--shard-batch", type=int, default=100000,
                    help="reads per shard batch (multi-host granularity)")
    al.add_argument("--merge", action="store_true",
                    help="merge part-dir into SAM on stdout and exit")
    al.add_argument("index_prefix")
    al.add_argument("read1")
    al.add_argument("read2", nargs="?")

    po = sub.add_parser("polish", help="re-score a salt SAM's multi-hits")
    po.add_argument("-s", "--sw", action="store_true")
    po.add_argument("-p", "--pe", action="store_true")
    po.add_argument("index_prefix")
    po.add_argument("sam")

    et = sub.add_parser(
        "snp-etl", help="variant-format converters (dbSNP/VCF -> hapmap)",
        add_help=False,
    )
    et.add_argument("rest", nargs=argparse.REMAINDER)

    ev = sub.add_parser(
        "alneval", help="wgsim accuracy evaluation of a SAM", add_help=False
    )
    ev.add_argument("rest", nargs=argparse.REMAINDER)

    sim = sub.add_parser(
        "wgsim", help="simulate reads (wgsim-compatible)", add_help=False
    )
    sim.add_argument("rest", nargs=argparse.REMAINDER)

    rt = sub.add_parser(
        "readtools", help="FASTQ downsampler / unmapped-record dump",
        add_help=False,
    )
    rt.add_argument("rest", nargs=argparse.REMAINDER)

    args = ap.parse_args(argv)
    if args.cmd == "wgsim":
        from .sim.wgsim import wgsim_main

        return wgsim_main(args.rest)
    if args.cmd == "readtools":
        from .eval.readtools import readtools_main

        return readtools_main(args.rest)
    if args.cmd == "snp-etl":
        from .etl.snp_etl import _main as etl_main

        return etl_main(args.rest)
    if args.cmd == "alneval":
        from .eval.wgsim_eval import _main as eval_main

        return eval_main(args.rest)
    if args.cmd == "idx":
        from .index.build import build_index, build_index_from_data
        from .index.store import save_index
        from .io.fasta import read_records
        from .io.snp import read_snp_blocks

        mode = "reference_compat" if args.compat_rpart else "exact"
        contig_data = [(r.name, r.comment or "(null)", r.seq)
                       for r in read_records(args.ref_fa)]
        blocks = list(read_snp_blocks(args.snp_file))
        idx = build_index_from_data(contig_data, blocks,
                                    l_seed=args.seed_len, r_anchor_mode=mode)
        save_index(idx, args.prefix)
        if args.shards > 0:
            import json

            from .parallel.sharded import partition_contigs_contiguous

            lengths = [len(c[2]) for c in contig_data]
            bins = partition_contigs_contiguous(lengths, args.shards)
            for si, b in enumerate(bins):
                sub = build_index_from_data(
                    [contig_data[i] for i in b],
                    [blocks[i] for i in b if i < len(blocks)],
                    l_seed=args.seed_len, r_anchor_mode=mode,
                )
                save_index(sub, f"{args.prefix}.shard{si}")
            with open(args.prefix + ".shards.json", "w") as fh:
                json.dump({"n_shards": args.shards, "bins": bins}, fh)
        return 0

    if args.cmd == "aln":
        from .index.store import load_index
        from .pipeline.engine import SEAligner, SEOptions

        if args.threads != 1:
            print(f"[aln] -t {args.threads} ignored: batches are "
                  "data-parallel on the device; use --part-dir + multiple "
                  "processes to scale hosts", file=sys.stderr)
        if args.num != -1:
            print("[aln] -n is inert (the reference overwrites max_diff "
                  "internally, alnse.c:1016,1090); accepted for "
                  "compatibility", file=sys.stderr)
        if args.read_length != 100:
            print("[aln] -l is inert (read length is taken from the "
                  "input); accepted for compatibility", file=sys.stderr)
        idx = load_index(args.index_prefix)
        l_overlap = args.overlap if args.overlap > 0 else idx.l_seed
        shard_ixs = shard_bins = None
        if args.shards > 0:
            import json

            with open(args.index_prefix + ".shards.json") as fh:
                man = json.load(fh)
            if man["n_shards"] != args.shards:
                print(f"[aln] index was sharded {man['n_shards']}-way; "
                      f"using that (requested {args.shards})",
                      file=sys.stderr)
            shard_ixs = [load_index(f"{args.index_prefix}.shard{i}")
                         for i in range(man["n_shards"])]
            shard_bins = man["bins"]
        if args.merge:
            from .io.sam import sam_header
            from .parallel.driver import merge_parts

            merge_parts(args.part_dir, sys.stdout,
                        sam_header(idx, " ".join(["salt-tpu"] + argv),
                                   args.group))
            return 0
        if args.pe:
            from .pipeline.pe_engine import PEAligner, PEOptions

            opts = PEOptions(
                l_overlap=l_overlap,
                max_seed=args.max_seed,
                max_locate=args.max_locate,
                min_tlen=args.min_tlen,
                max_tlen=args.max_tlen,
                print_xa_cigar=args.xa_cigar,
                print_nm_md=args.md,
                rg_id=args.group,
                batch_size=args.batch_size,
                sa_mode=args.sa_mode,
            )
            if shard_ixs is not None:
                from .parallel.sharded_engine import ShardedPEAligner

                al = ShardedPEAligner(
                    idx, shard_ixs, opts, bins=shard_bins,
                    contig_lengths=[c.length for c in idx.contigs],
                )
            else:
                al = PEAligner(idx, opts)
            if args.part_dir:
                from .parallel.driver import (align_file_sharded,
                                              maybe_init_distributed)

                pid, npro = maybe_init_distributed()
                align_file_sharded(al, args.read1, args.part_dir, pid, npro,
                                   batch_size=args.shard_batch,
                                   fastq2=args.read2)
            else:
                al.align_files(args.read1, args.read2, sys.stdout,
                               cmd=" ".join(["salt-tpu"] + argv))
        else:
            opts = SEOptions(
                l_overlap=l_overlap,
                max_seed=args.max_seed,
                max_locate=args.max_locate,
                print_xa_cigar=args.xa_cigar,
                print_nm_md=args.md,
                rg_id=args.group,
                batch_size=args.batch_size,
                extend_algo="sw" if args.extend == 1 else "lv",
                sa_mode=args.sa_mode,
            )
            if shard_ixs is not None:
                from .parallel.sharded_engine import ShardedSEAligner

                al = ShardedSEAligner(
                    idx, shard_ixs, opts, bins=shard_bins,
                    contig_lengths=[c.length for c in idx.contigs],
                )
            else:
                al = SEAligner(idx, opts)
            if args.part_dir:
                from .parallel.driver import (align_file_sharded,
                                              maybe_init_distributed)

                pid, npro = maybe_init_distributed()
                align_file_sharded(al, args.read1, args.part_dir, pid, npro,
                                   batch_size=args.shard_batch)
            else:
                al.align_file(args.read1, sys.stdout,
                              cmd=" ".join(["salt-tpu"] + argv))
        return 0

    if args.cmd == "polish":
        from .index.store import load_index
        from .polish.polish import polish_main

        idx = load_index(args.index_prefix)
        polish_main(idx, args.sam, paired=args.pe, use_sw=args.sw)
        return 0


if __name__ == "__main__":
    sys.exit(main())
