"""Smoke test of the system on one NVIDIA GPU: the quickest proof that the
main path still starts and agrees with the host oracle on the card.

    python chip_smoke.py            # one GPU: identity, stages, end to end
    python chip_smoke.py --mesh 4   # only the 4-GPU --mesh path vs one GPU

Phases (each prints its results; any failure exits non-zero):
  identity   card name and power limit (nvidia-smi), JAX version, devices;
             fails unless JAX's platform is 'gpu'.
  stages     each device stage of the anchor path, compiled for the card at
             the flagship widths (rows of 2,097,152 windows, 8 per batch):
             memory analysis, exact comparison with the host oracle (native
             join + build_anchor_tables), and the device time per batch.
  end2end    the reference's largest published configuration (49
             haplotypes x 5 Mbp, 2x coverage of 150 bp reads, seed 0)
             through `phi_tpu.cli.main -k 31 -w 25 -R 100`: one cold run,
             then warm runs, against the host oracle run in this process
             (`run_pipeline(..., Options(device="cpu"))`). Requires the
             FASTA byte-identical to the oracle's, a certified gap, and the
             device-anchor path taken with no [W::anchors] reroute.
  mesh       (--mesh N only) the same instance with --mesh N against a
             one-GPU run, byte-identical.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(n_haps=49, length=5_000_000, coverage=2.0, seed=0)
STAGE_INSTANCE = dict(n_haps=4, length=3_000_000, seed=1)  # 8 full rows
K, W, R = 31, 25, 100


def log(msg: str) -> None:
    print(msg, flush=True)


def identity():
    import jax
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = "nvidia-smi unavailable"
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    log(f"[identity] card: {card}")
    log(f"[identity] jax {jax.__version__}; devices: "
        f"{[f'{d.platform}:{d.device_kind}' for d in devs]}")
    return card, devs


def _tee_stderr():
    """Capture stderr (the [M::]/[W::] phase log) while still showing it."""
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return sys.__stderr__.write(s)

        def flush(self):
            sys.__stderr__.flush()

    return buf, contextlib.redirect_stderr(Tee())


def _synthetic(tmp: str, n_haps: int, length: int, seed: int):
    """A smaller instance for the stage phase: rows at full width."""
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.graph import tensorize
    from phi_tpu.io.gfa import read_gfa, write_gfa
    rng = np.random.default_rng(seed)
    gfa, haps = synth_pangenome(rng, length=length, n_haps=n_haps,
                                var_rate=0.01, indel_fraction=0.05)
    path = os.path.join(tmp, f"stage_{n_haps}_{length}_{seed}.gfa")
    write_gfa(gfa, path=path)
    reads, _ = sample_reads(rng, haps, coverage=2.0, read_len=150,
                            error_rate=0.002)
    return tensorize(read_gfa(path)), reads


def _spectrum(reads, k, w):
    from phi_tpu.io.gfa import encode_seq
    from phi_tpu.sketch.minimizer import sketch_read_concat
    concat = np.concatenate([encode_seq(r) for r in reads])
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=off[1:])
    return sketch_read_concat(concat, off, k, w)


def _time_device(fn, args, reps: int = 5) -> float:
    """Median wall seconds of fn(*args) with block_until_ready (warm)."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def stages(tmp: str) -> None:
    """Compile, compare and time every device stage of the anchor path."""
    import jax
    import jax.numpy as jnp

    from phi_tpu.anchors.device import join_anchors_device
    from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
    from phi_tpu.ops.search import make_cuckoo
    from phi_tpu.sketch import rows as rw
    from phi_tpu.sketch.minimizer import prepare_spectrum_bucket

    graph, reads = _synthetic(tmp, **STAGE_INSTANCE)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    for (k, w, name) in ((K, W, "narrow k=31 w=25"),
                         (47, 25, "wide k=47 w=25")):
        spectrum = _spectrum(reads, k, w)
        want = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                                   spectrum, 1.0)
        buf, tee = _tee_stderr()
        with tee:
            res = join_anchors_device(graph, seqs, k, w, spectrum[0],
                                      spectrum[1], 1.0)
        if res is None or "[W::anchors]" in buf.getvalue():
            raise SystemExit(f"[stages] {name}: device path rerouted")
        per_hap_min, occ = res
        hap, s, e, kid = occ.materialize()
        same = (np.array_equal(per_hap_min, want.per_hap_minimizers)
                and occ.n_model == want.n_model_kmers
                and occ.filtered == want.filtered_kmers
                and np.array_equal(hap, want.occ_hap)
                and np.array_equal(s, want.occ_start)
                and np.array_equal(e, want.occ_end)
                and np.array_equal(kid, want.occ_kmer))
        log(f"[stages] {name}: anchors vs host oracle "
            f"{'identical' if same else 'DIFFER'} "
            f"({occ.n_occ} occurrences, {int(per_hap_min.sum())} minimizers)")
        if not same:
            raise SystemExit(1)

    # one full-width batch per stage variant: memory analysis, wall time of
    # the batch on the card, and the mixed-key probe (the no-cuckoo
    # fallback) compared exactly with the cuckoo probe
    sup, Rr = rw.ROW_WINDOWS, rw.ROWS
    lanes = rw.row_lanes(sup)
    cl = graph.walk_node_cumlen
    outs = {}
    for (k, w, probe) in ((K, W, "cuckoo"), (K, W, "mixed"),
                          (47, 25, "cuckoo")):
        spectrum = _spectrum(reads, k, w)
        halo = k + w - 2
        rows = [(i, st, min(sup, len(c) - halo - st), 1 if st else 0)
                for i, c in enumerate(seqs)
                for st in range(0, len(c) - halo, sup)][:Rr]
        rows += [(-1, 0, 0, 0)] * (Rr - len(rows))
        S_cap = rw.row_start_cap(cl, rows, lanes)
        args = (jnp.asarray(rw.pack_rows_2bit(seqs, rows, lanes)),
                jnp.asarray(rw.pack_row_starts(cl, rows, lanes, S_cap)),
                jnp.asarray(np.array([r[2] for r in rows], np.int32)),
                jnp.asarray(np.array([r[3] for r in rows], np.int32)),
                jnp.asarray(rw.row_base_nodes(cl, rows)),
                jnp.asarray(np.array([max(r[0], 0) for r in rows],
                                     np.int32)))
        if probe == "cuckoo":
            Thi, Tlo, Tid, seed, _ = make_cuckoo(np.asarray(spectrum[0]),
                                                 np.asarray(spectrum[1]))
            sp = (jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
                  jnp.uint32(seed))
        else:
            m_np, lo_np, perm_np, off_np, _, rounds, _ = \
                prepare_spectrum_bucket(*spectrum)
            sp = tuple(jnp.asarray(a) for a in
                       (m_np, lo_np, perm_np, off_np)) + (jnp.int32(rounds),)
        emitcap, cap_total = rw.join_caps(w, sup, Rr)
        st = dict(k=k, w=w, emitcap=emitcap, cap_total=cap_total,
                  probe=probe)
        name = f"join_rows k={k} w={w} {probe}"
        compiled = rw.join_rows.lower(*args, sp, **st).compile()
        log(f"[stages] {name} memory: {compiled.memory_analysis()}")
        outs[(k, probe)] = jax.device_get(rw.join_rows(*args, sp, **st))
        t = _time_device(lambda *x: rw.join_rows(*x, sp, **st), args)
        log(f"[stages] {name}: {t * 1e3:.3f} ms per 8-row batch (wall, "
            f"warm, median of 5)")
    a, b = outs[(K, "cuckoo")], outs[(K, "mixed")]
    nh = int(a[1].sum())
    same = all(np.array_equal(a[i], b[i]) for i in (0, 1)) and all(
        np.array_equal(a[i][:nh], b[i][:nh]) for i in (2, 3, 4))
    log(f"[stages] mixed-key probe vs cuckoo probe: "
        f"{'identical' if same else 'DIFFER'} ({nh} hits in the batch)")
    if not same:
        raise SystemExit(1)


def _cli_run(paths: dict, out: str, extra=()):
    """phi_tpu.cli.main on the instance; returns (PipelineResult, stderr,
    wall seconds)."""
    import phi_tpu.pipeline as pp
    from phi_tpu import cli
    captured = []
    inner = pp.run_pipeline

    def recording(*a, **kw):
        captured.append(inner(*a, **kw))
        return captured[-1]

    buf, tee = _tee_stderr()
    pp.run_pipeline = recording
    try:
        t = time.perf_counter()
        with tee:
            rc = cli.main(["-g", paths["gfa"], "-r", paths["reads"], "-o", out,
                           "-k", str(K), "-w", str(W), "-R", str(R),
                           *extra])
        wall = time.perf_counter() - t
    finally:
        pp.run_pipeline = inner
    if rc != 0 or not captured:
        raise SystemExit(f"phi exited {rc}")
    return captured[0], buf.getvalue(), wall


def _instance():
    from phi_tpu.eval.scale import build_instance
    t = time.perf_counter()
    paths = build_instance(FLAGSHIP["n_haps"], FLAGSHIP["length"],
                           coverage=FLAGSHIP["coverage"],
                           seed=FLAGSHIP["seed"])
    log(f"[end2end] instance {FLAGSHIP} ready in "
        f"{time.perf_counter() - t:.1f} s: {paths['gfa']}")
    return paths


def end2end(tmp: str, warm_runs: int = 2) -> None:
    import jax

    from phi_tpu.config import Options
    from phi_tpu.eval.edits import edit_stats
    from phi_tpu.pipeline import gap_tol, run_pipeline

    paths = _instance()
    out = os.path.join(tmp, "gpu.fa")
    for i in range(1 + warm_runs):
        res, err, wall = _cli_run(paths, out)
        label = "cold" if i == 0 else f"warm{i}"
        gap = max(0.0, res.decode.true_objective - res.decode.dp_objective)
        log(f"[end2end] {label}: wall {wall:.3f} s; timings "
            + json.dumps({k: round(v, 3) for k, v in res.timings.items()}))
        if "[W::anchors]" in err or res.anchors.device_occ is None:
            raise SystemExit("[end2end] device-anchor path not taken")
        if gap > gap_tol(R):
            raise SystemExit(f"[end2end] gap {gap} > {gap_tol(R)}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[end2end] peak_bytes_in_use: {stats.get('peak_bytes_in_use')} "
        f"of bytes_limit {stats.get('bytes_limit')}")
    log(f"[end2end] gap {gap:.3f} <= {gap_tol(R)} (certified); "
        f"recombinations {res.recombination_count}; device anchors "
        f"{res.anchors.device_occ.n_occ} retained occurrences")

    t = time.perf_counter()
    oracle_out = os.path.join(tmp, "host.fa")
    ref = run_pipeline(paths["gfa"], paths["reads"], oracle_out,
                       Options(k=K, w=W, recombination=R, device="cpu"))
    log(f"[end2end] host oracle: wall {time.perf_counter() - t:.3f} s; "
        "timings " + json.dumps({k: round(v, 3)
                                 for k, v in ref.timings.items()}))
    with open(out, "rb") as f, open(oracle_out, "rb") as g:
        identical = f.read() == g.read()
    log(f"[end2end] FASTA vs host oracle: "
        f"{'byte-identical' if identical else 'DIFFERENT'}")
    if not identical:
        raise SystemExit(1)
    with open(paths["truth"]) as f:
        truth = "".join(l.strip() for l in f if not l.startswith(">"))
    es = edit_stats(res.sequence, truth)
    log(f"[end2end] edit distance to truth: {es.edit_distance} "
        f"(identity {es.identity:.6f})")


def mesh(tmp: str, n: int) -> None:
    import jax
    if len(jax.devices()) < n:
        raise SystemExit(f"--mesh {n} needs {n} GPUs, found "
                         f"{len(jax.devices())}")
    paths = _instance()
    one = os.path.join(tmp, "one.fa")
    many = os.path.join(tmp, f"mesh{n}.fa")
    _, _, w1 = _cli_run(paths, one)
    res, _, wn = _cli_run(paths, many, ("--mesh", str(n)))
    _, _, wn2 = _cli_run(paths, many, ("--mesh", str(n)))
    with open(one, "rb") as f, open(many, "rb") as g:
        identical = f.read() == g.read()
    log(f"[mesh] one GPU wall {w1:.3f} s; --mesh {n} wall {wn:.3f} s cold, "
        f"{wn2:.3f} s warm; timings "
        + json.dumps({k: round(v, 3) for k, v in res.timings.items()}))
    log(f"[mesh] --mesh {n} FASTA vs one GPU: "
        f"{'byte-identical' if identical else 'DIFFERENT'}")
    if not identical:
        raise SystemExit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, default=0,
                    help="run only the N-GPU --mesh phase against one GPU")
    args = ap.parse_args()
    import jax

    from phi_tpu import CHECKOUT
    card, devs = identity()
    tmp = os.path.join(CHECKOUT, "chiprun_out", "smoke")
    os.makedirs(tmp, exist_ok=True)
    if args.mesh:
        mesh(tmp, args.mesh)
    else:
        stages(tmp)
        end2end(tmp)
    log(f"[identity] card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
