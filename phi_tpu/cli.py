"""Reference-compatible command line (main.cpp:38-95 flag surface).

    phi -g graph.gfa -r reads.fq -o hap.fa [-k 31 -w 25 -R 100 -T 1.0
        -q 1 -m 1 -N 0 -t 32 -c 5000 -d 0]

-q/-m/-N select the reference's solver variants (IQP/ILP, mixed/integer,
naive/optimized expanded graph). All variants share one objective, which the
DP solves directly, so here they only affect logging — documented
deviation, same optimum.
"""

from __future__ import annotations

import argparse
import sys

from phi_tpu import __version__
from phi_tpu import logging as plog
from phi_tpu.config import Options


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phi",
        description="PHI-TPU: pangenome haplotype inference (JAX, GPU or CPU)")
    p.add_argument("-g", dest="gfa", required=False, help="GFA file")
    p.add_argument("-r", dest="reads", required=False, help="reads (FASTA/FASTQ)")
    p.add_argument("-o", dest="out", required=False, help="output haplotype FASTA")
    p.add_argument("-k", type=int, default=31, help="k-mer size [31]")
    p.add_argument("-w", type=int, default=25, help="minimizer window size [25]")
    p.add_argument("-R", type=float, default=100, help="recombination penalty [100]")
    p.add_argument("-T", type=float, default=1.0, help="minimizer filter threshold [1.0]")
    p.add_argument("-q", type=int, default=1, help="mode QP/ILP (compat) [1]")
    p.add_argument("-m", type=int, default=1, help="mixed/integer (compat) [1]")
    p.add_argument("-N", type=int, default=0, help="naive expanded graph (compat) [0]")
    p.add_argument("-t", type=int, default=0, help="host threads (0 = auto)")
    p.add_argument("-c", type=int, default=5000, help="max k-mer occurrence (compat) [5000]")
    p.add_argument("-d", type=int, default=0, help="debug mode [0]")
    p.add_argument("--sweeps", type=int, default=256, help="DP sweep cap [256]")
    p.add_argument("--lagrangian", type=int, default=8,
                   help="Lagrangian refinement rounds when gap > 0 [8]")
    p.add_argument("--mesh", type=int, default=0,
                   help="solve over an N-device mesh (hap x sp sharding) [off]")
    p.add_argument("--save-index", default=None, metavar="NPZ",
                   help="persist spectrum + join hits for parameter re-solves")
    p.add_argument("--load-index", default=None, metavar="NPZ",
                   help="reuse a saved index (skips read loading + sketching)")
    p.add_argument("--version", action="store_true", help="print version")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"PHI version: {__version__}")
        return 0
    if not (args.gfa and args.out and (args.reads or args.load_index)):
        build_parser().print_usage(sys.stderr)
        return 1

    plog.reset_timer()
    try:
        opt = Options(k=args.k, w=args.w, recombination=args.R, threshold=args.T,
                      is_qclp=args.q, is_mixed=args.m, is_naive_exp=args.N,
                      num_threads=args.t, max_occ=args.c, debug=bool(args.d),
                      max_sweeps=args.sweeps, lagrangian_rounds=args.lagrangian,
                      mesh_devices=args.mesh, save_index=args.save_index,
                      load_index=args.load_index)

        from phi_tpu.pipeline import run_pipeline
        run_pipeline(args.gfa, args.reads, args.out, opt)
    except (ValueError, OSError, RuntimeError) as e:
        # reference prints [E::main] and returns 1 on load failures
        # (main.cpp:102-105) rather than aborting with a traceback
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    plog.footer(__version__, ["phi"] + argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
