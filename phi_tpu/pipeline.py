"""End-to-end orchestration: graph + reads -> inferred haplotype FASTA.

The accelerator equivalent of the reference's ILP_index::ILP_function
(src/ILP_index.cpp:528-1601), emitting the same [M::...] phase-log
contract (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phi_tpu import logging as plog
from phi_tpu.anchors.join import AnchorTables
from phi_tpu.config import Options
from phi_tpu.emit import recombination_report
from phi_tpu.graph import PangenomeGraph, tensorize
from phi_tpu.io.fasta import hap_name_from_paths, write_fasta
from phi_tpu.io.gfa import read_gfa
from phi_tpu.io.reads import load_read_batch
from phi_tpu.sketch.minimizer import sketch_read_batch
from phi_tpu.solve.decode import DecodeResult, decode_path
from phi_tpu.solve.dp import solve_dp
from phi_tpu.solve.prep import build_solver_tables


@dataclasses.dataclass
class PipelineResult:
    sequence: str
    decode: DecodeResult
    anchors: AnchorTables
    recombination_count: int
    report_segments: list[str]
    graph: PangenomeGraph
    timings: dict[str, float]


def enable_compile_cache() -> None:
    """JAX's persistent compile cache: the directory JAX_COMPILATION_CACHE_DIR
    names when it is set (JAX reads that variable itself), otherwise
    <checkout>/.jax_cache, which .gitignore lists."""
    import os

    import jax

    from phi_tpu import CHECKOUT
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(CHECKOUT, ".jax_cache"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


def run_pipeline(gfa_path: str, reads_path: str, out_path: str | None,
                 opt: Options) -> PipelineResult:
    """Run the whole pipeline on the platform `opt.device` selects
    (phi_tpu.placement: 'gpu', 'cpu', or None for JAX's default)."""
    from phi_tpu import placement
    enable_compile_cache()
    with placement.use(opt.device):
        return _run(gfa_path, reads_path, out_path, opt)


def _run(gfa_path: str, reads_path: str, out_path: str | None,
         opt: Options) -> PipelineResult:
    import time

    from phi_tpu.placement import on_device
    if opt.num_threads:
        from phi_tpu.native import set_threads
        set_threads(opt.num_threads)
    timings: dict[str, float] = {}
    t0 = time.time()

    graph = tensorize(read_gfa(gfa_path))
    if graph.n_vtx == 0:
        raise ValueError(f"no segments parsed from {gfa_path} "
                         "(is it a GFA v1.1 file?)")
    if graph.num_walks == 0:
        raise ValueError(f"{gfa_path} has no W-line haplotype walks; PHI "
                         "requires walks (convert VCF input with phi-vcf2gfa)")
    plog.log("main", f"Loaded graph from: {gfa_path}")
    timings["load_graph"] = time.time() - t0

    hits = None
    anchors = None
    if opt.load_index:
        # checkpoint path: spectrum + per-hap join hits were persisted by a
        # previous run (--save-index); parameter re-solves skip sketching
        from phi_tpu.checkpoint import load_index
        t1 = time.time()
        spectrum, hits, meta = load_index(opt.load_index)
        if meta and (int(meta.get("k", opt.k)) != opt.k
                     or int(meta.get("w", opt.w)) != opt.w):
            raise ValueError(
                f"index {opt.load_index} was built with k={meta.get('k')} "
                f"w={meta.get('w')}, run requests k={opt.k} w={opt.w}")
        if len(hits) != graph.num_walks:
            raise ValueError(
                f"index {opt.load_index} has {len(hits)} haplotypes, "
                f"graph has {graph.num_walks}")
        plog.log("ILP_function",
                 f"Loaded index from {opt.load_index}: spectrum "
                 f"{len(spectrum[0])}, {graph.num_walks} haplotypes")
        timings["load_reads"] = 0.0
        timings["sketch_reads"] = 0.0
        timings["sketch_haps"] = time.time() - t1
    else:
        t1 = time.time()
        reads = load_read_batch(reads_path)
        timings["load_reads"] = time.time() - t1
        plog.log("ILP_function",
                 f"Graph has {graph.n_vtx} vertices, {graph.num_walks} walks "
                 f"and read has {reads.n_reads} reads")

        # --- read spectrum (hot loop #2 in the reference; first here so the
        # haplotype sketch can join on device and ship only hits) ---
        # Mesh runs shard reads over the dp devices (SURVEY §2.4) and
        # round-robin haplotypes across devices for the join below.
        mesh_devices = None
        if opt.mesh_devices and opt.mesh_devices > 1:
            from phi_tpu.parallel.sharded import make_mesh
            mesh_devices = list(make_mesh(opt.mesh_devices).devices.reshape(-1))
        t1 = time.time()
        if reads.concat is not None:
            from phi_tpu.sketch.minimizer import sketch_read_concat
            spectrum = sketch_read_concat(reads.concat, reads.off, opt.k,
                                          opt.w, devices=mesh_devices)
        else:
            spectrum = sketch_read_batch(reads.codes, opt.k, opt.w, reads.lengths)
        timings["sketch_reads"] = time.time() - t1

        # --- haplotype sketching + anchor join (hot loops #1 and #3) ---
        # device join per haplotype; sketch_join_sequence falls back to the
        # exact host join automatically for walks containing non-ACGT bases
        t1 = time.time()
        import jax.numpy as jnp

        from phi_tpu.sketch.minimizer import sketch_join_many
        plog.raw("Number of Minimizers")
        hits = None
        anchors = None
        import os as _os
        use_dev_anchors = (
            (on_device()
             or _os.environ.get("PHI_TPU_FORCE_DEVICE_ANCHORS") == "1")
            and mesh_devices is None and not opt.save_index
            and len(spectrum[0]) > 0)
        if use_dev_anchors:
            # device-resident anchor pipeline: hits never leave the device
            # (anchors/device.py); the documented capacity cases (N-containing
            # walks, H > 255, cap overflows) return None with a [W::anchors]
            # line and take the host hit path below. Any other failure fails
            # the run.
            from phi_tpu.anchors.device import join_anchors_device
            hap_codes = [graph.walk_seq_codes(h)
                         for h in range(graph.num_walks)]
            dres = join_anchors_device(
                graph, hap_codes, opt.k, opt.w, spectrum[0], spectrum[1],
                opt.threshold)
            if dres is not None:
                from phi_tpu.anchors.join import AnchorTables
                per_hap_min, dev_occ = dres
                dev_occ.start_host_copy()
                for h in range(graph.num_walks):
                    plog.raw(f"{graph.walk_names[h]} : {per_hap_min[h]}")
                anchors = AnchorTables(
                    occ_hap=None, occ_start=None, occ_end=None,
                    occ_kmer=None, occ_weight=None,
                    n_model_kmers=dev_occ.n_model,
                    spectrum_size=len(spectrum[0]),
                    filtered_kmers=dev_occ.filtered,
                    per_hap_minimizers=per_hap_min,
                    per_hap_anchors=dev_occ.per_hap_anchors,
                    device_occ=dev_occ)
        if anchors is None:
            sp_hi_d = jnp.asarray(spectrum[0])
            sp_lo_d = jnp.asarray(spectrum[1])
            if (not on_device() or opt.k > 31) and mesh_devices is None:
                # stream walks straight from the graph tensors (no per-hap
                # concatenations); exact same join semantics. k > 31 lives
                # only on the native 128-bit scan, any backend.
                from phi_tpu.sketch.minimizer import sketch_join_walks
                hits = sketch_join_walks(graph, opt.k, opt.w,
                                         spectrum[0], spectrum[1])
            if hits is None:
                hap_codes = [graph.walk_seq_codes(h)
                             for h in range(graph.num_walks)]
                hits = sketch_join_many(hap_codes, opt.k, opt.w, sp_hi_d,
                                        sp_lo_d, devices=mesh_devices)
            for h in range(graph.num_walks):
                plog.raw(f"{graph.walk_names[h]} : {hits[h][0]}")
        plog.log("ILP_function", "Haplotypes sketched")
        timings["sketch_haps"] = time.time() - t1
        plog.log("ILP_function",
                 f"Indexed reads with spectrum size: {len(spectrum[0])}")
        if opt.save_index:
            from phi_tpu.checkpoint import save_index
            save_index(opt.save_index, spectrum, hits,
                       meta={"k": opt.k, "w": opt.w})
            plog.log("ILP_function", f"Index saved to {opt.save_index}")

    if opt.debug:
        _debug_sharing_histogram(graph, opt)

    from phi_tpu.anchors.join import anchor_tables_from_hits

    # --- anchor tables: interval conversion + threshold filter ---
    t1 = time.time()
    if hits is not None or anchors is None:
        anchors = anchor_tables_from_hits(graph, opt.k, hits,
                                          len(spectrum[0]), opt.threshold)
    plog.raw("Number of Anchors")
    for h in range(graph.num_walks):
        plog.raw(f"{graph.walk_names[h]} : {anchors.per_hap_anchors[h]}")
    sp = max(anchors.spectrum_size, 1)
    plog.log("ILP_function",
             f"Filtered/Retained Minimizers: "
             f"{anchors.filtered_kmers / sp * 100:.2f}/"
             f"{(sp - anchors.filtered_kmers) / sp * 100:.2f}%")
    plog.log("ILP_function",
             f"{anchors.n_model_kmers * 100.0 / sp:.2f}% Minimizers are in ILP")
    timings["anchors"] = time.time() - t1

    # --- solve (replaces Gurobi, hot loop #4) ---
    mode = ("QP" if opt.is_qclp else "ILP")
    plog.log("ILP_function", f"{mode} model started")
    plog.log("ILP_function",
             "Using Mixed Integer Programming" if opt.is_mixed
             else "Using Integer Programming")
    # Runtime deviation banner: in the reference -q/-m/-N pick among four
    # Gurobi formulations of one objective (main.cpp:79-95); the DP solver
    # reaches that shared optimum directly, so here they select logging
    # only. -c (max_occ) is likewise accepted for compatibility (the
    # reference parses but never applies it in the solve path either).
    plog.log("ILP_function",
             f"Compat: -q{opt.is_qclp} -m{opt.is_mixed} -N{opt.is_naive_exp} "
             f"select equivalent formulations (DP solves the shared optimum "
             f"directly); -c {opt.max_occ} accepted, unused")
    t1 = time.time()
    result = _solve_with_refinement(graph, anchors, opt)
    from phi_tpu.solve.dp import LAST_TIMINGS
    for key, val in LAST_TIMINGS.items():
        timings[f"solve_{key}"] = val
    plog.log("ILP_function", "Model optimized")
    plog.log("ILP_function",
             f"DP sweeps: {result.n_sweeps}; lower bound: {result.dp_objective:.3f}; "
             f"path objective: {result.true_objective:.3f}; "
             f"gap: {max(0.0, result.true_objective - result.dp_objective):.3f}")
    timings["solve"] = time.time() - t1

    if opt.debug:
        # debug-mode detail, the solver-appropriate analog of the reference's
        # model dumps + chosen-path trace (-d1, ILP_index.cpp:1423-1429,:1554)
        _debug_model_dump(graph, anchors, opt)
        for (sh, sq, sp) in result.segments:
            plog.raw(f"[D] segment lane={graph.walk_names[sh]} walk_pos=[{sq},{sp}] "
                     f"vertices=[{graph.walk_mat[sh, sq]}..{graph.walk_mat[sh, sp]}]")
        plog.raw(f"[D] matched distinct k-mers: {result.matched_distinct} / "
                 f"{anchors.n_model_kmers}; weighted occurrence credit: "
                 f"{result.matched_total:.1f}")

    # --- report + emit ---
    recomb, segs = recombination_report(graph, result.vertices, result.vertex_hap)
    plog.raw(f"Recombination count: {recomb}")
    plog.raw("Recombined haplotypes: " + "".join(segs))

    t1 = time.time()
    seq = graph.path_seq(result.vertices)
    if out_path is not None:
        name = hap_name_from_paths(gfa_path, reads_path or opt.load_index or "index")
        write_fasta(out_path, name, seq)
        plog.log("ILP_function",
                 f"Haplotype of size: {len(seq)} written to: {out_path}")
    timings["emit"] = time.time() - t1
    timings["total"] = time.time() - t0

    return PipelineResult(
        sequence=seq, decode=result, anchors=anchors,
        recombination_count=recomb, report_segments=segs,
        graph=graph, timings=timings,
    )


def _debug_sharing_histogram(graph: PangenomeGraph, opt: Options) -> None:
    """The reference's debug k-mer sharing histogram
    (ILP_index.cpp:576-606): for each distinct haplotype minimizer, in how
    many walks it occurs; printed as shared fractions."""
    from phi_tpu.anchors.join import sketch_haplotypes
    from phi_tpu.sketch.encode import combine64
    sketches = sketch_haplotypes(graph, opt.k, opt.w)
    parts = [np.unique(combine64(hi, lo)) for hi, lo, _ in sketches]
    allk = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    uniq, cnt = np.unique(allk, return_counts=True)
    hist = np.bincount(cnt, minlength=graph.num_walks + 1)
    total = max(len(uniq), 1)
    plog.raw("Shared fraction of unique kmers by haplotypes")
    for i in range(1, graph.num_walks + 1):
        plog.raw(f"[Haplotypes: {i}, fraction of unique shared kmers: "
                 f"{hist[i] / total:.5f}]")


def _debug_model_dump(graph: PangenomeGraph, anchors: AnchorTables,
                      opt: Options) -> None:
    """Full model dump, the analog of the reference's -d1 printers
    (printObjectiveFunction/printConstraints/printNonZeroVariables,
    ILP_index.cpp:157-310 invoked at :1423-1429). Dense tables replace named
    Gurobi variables, so the dump lists the credit tables per lane, every
    switch edge with its cost, and every occurrence interval (the k-mer
    constraint analog). Like the reference's dump it is only practical on
    toy models; larger models print a summary line instead."""
    from phi_tpu.solve.prep import build_solver_tables, solver_layers
    t = build_solver_tables(graph, anchors, opt.recombination,
                            solver_layers(graph, opt.k)).dense()
    H, P = t.state_vertex.shape
    n_occ = len(anchors.occ_hap)
    if H * P > 20_000 or len(t.esrc_h) > 50_000 or n_occ > 50_000:
        plog.raw(f"[D] model dump skipped (too large): {H}x{P} lane states, "
                 f"{len(t.esrc_h)} switch edges, {n_occ} occurrences")
        return
    plog.raw(f"[D] objective: minimize {t.R:g}*switches - covered_credit "
             f"+ {t.const:g}")
    for h in range(H):
        L = int(t.walk_len[h])
        s_row = " ".join(f"{t.S[h, p]:g}" for p in range(L))
        b_row = " ".join(f"{t.B[h, p]:g}" for p in range(L))
        plog.raw(f"[D] lane {graph.walk_names[h]}: S=[{s_row}] B=[{b_row}]")
    for i in range(len(t.esrc_h)):
        h, p = int(t.esrc_h[i]), int(t.esrc_p[i])
        plog.raw(f"[D] switch ({graph.walk_names[h]},{p}) -> "
                 f"vertex {int(t.esrc_target[i])} cost {t.R:g}")
    for i in range(n_occ):
        plog.raw(f"[D] occ kmer={int(anchors.occ_kmer[i])} "
                 f"lane={graph.walk_names[int(anchors.occ_hap[i])]} "
                 f"span=[{int(anchors.occ_start[i])},{int(anchors.occ_end[i])}) "
                 f"weight={float(anchors.occ_weight[i]):g}")


def _solve_once(tables, opt: Options):
    """Single-chip or mesh-sharded solve, by Options.mesh_devices."""
    if opt.mesh_devices and opt.mesh_devices > 1:
        from phi_tpu.parallel.sharded import make_mesh, solve_dp_sharded
        mesh = make_mesh(opt.mesh_devices)
        return solve_dp_sharded(tables, mesh, opt.max_sweeps)
    return solve_dp(tables, opt.max_sweeps)


def _hydrate_tables(tables, anchors) -> None:
    """Fill host occurrence columns on device-anchor runs: decode's lazy
    straddle/S_row/scoring reads them. The async copies were started right
    after the device anchor build, so by post-solve time they have landed."""
    anchors.materialize_device()
    if tables.occ_hap is None and anchors.occ_hap is not None:
        tables.occ_hap = anchors.occ_hap
        tables.occ_start = anchors.occ_start
        tables.occ_end = anchors.occ_end
        tables.occ_weight = anchors.occ_weight


def _solve_and_decode(graph, tables, anchors, opt: Options) -> DecodeResult:
    """Solve and decode. Normal case (tables.n_layers set): one exact-credit
    fixpoint — the decoded path is the optimal relaxed path and the value a
    valid bound. Bracket fallback (pathological spans, W=None): both the
    search and the optimistic fixpoints are decoded and the better-scoring
    path kept (they bracket the non-separable credit from below/above)."""
    if opt.mesh_devices and opt.mesh_devices > 1:
        _hydrate_tables(tables, anchors)
        M, ends, sweeps, lb = _solve_once(tables, opt)
        return decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    if tables.n_layers is not None:
        M, ends, sweeps, lb = solve_dp(tables, opt.max_sweeps)
        _hydrate_tables(tables, anchors)
        return decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    _hydrate_tables(tables, anchors)
    from phi_tpu.solve.dp import solve_dp_both
    (M, ends), (M_opt, ends_opt), sweeps, lb = solve_dp_both(tables, opt.max_sweeps)
    best = decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    try:
        t_opt = dataclasses.replace(tables, S=tables.B, n_layers=None)
        cand = decode_path(graph, t_opt, anchors, M_opt, ends_opt, sweeps, lb)
        if cand.true_objective < best.true_objective:
            best = cand
    except RuntimeError:
        pass  # optimistic backtrace can fail on degenerate ties; search path stands
    return best



def gap_tol(R: float) -> float:
    """Certification tolerance for the duality gap. Objective differences
    are a*R + b with integer a (switch count delta) and integer b (distinct
    k-mer delta), so with INTEGER R any two distinct objective values
    differ by >= 1: a bound strictly above opt - 1 excludes every better
    integer solution, so the full tolerance 1 - eps is a valid optimality
    certificate (round 5; previously 0.5 — needlessly forfeiting
    certification on real-data cells whose dual stalls in (0.5, 1)). With
    fractional R < 1 the smallest step is R itself — a loose tolerance
    would admit a path with one extra cheap switch (measured on the
    frontier sweep: excess exactly R at R in {0.1, 0.25, 0.5}); scale
    down accordingly. Fractional R >= 1 keeps 0.5: steps can be as small
    as frac(R) there, a documented residual (eval/frontier.py)."""
    if R > 0 and float(R).is_integer():
        return 0.99   # 0.01 margin over observed f32 bound noise (~1e-3)
    return 0.5 * min(1.0, R) if R > 0 else 0.0


def _solve_with_refinement(graph: PangenomeGraph, anchors: AnchorTables,
                           opt: Options) -> DecodeResult:
    """One DP solve; if the decoded path's exact objective is above the DP
    bound (duplicate k-mer credit), run Lagrangian reweighting rounds:
    per-kmer multipliers mu_i in [0,1] scale occurrence weights, updated by
    Polyak-stepped subgradients (g_i = covered multiplicity - 1 on the
    current relaxation path: duplicates push mu down, uncovered k-mers
    restore it toward 1); valid lower bound max_mu L(mu), best primal path
    kept, loop stops early when the bound certifies or stalls (DESIGN.md)."""
    from phi_tpu.solve.prep import _bucket_layers, solver_layers
    layers = solver_layers(graph, opt.k)
    if anchors.occ_hap is not None and len(anchors.occ_hap):
        # the graph-derived layer count is the worst case over any read
        # set; shrink it to the anchors' actual max span — the W stack and
        # every solver sweep scale with L
        actual = int((anchors.occ_end - anchors.occ_start).max())
        layers = min(layers, _bucket_layers(actual - 1))
    elif anchors.device_occ is not None and anchors.device_occ.max_span > 0:
        # the device-anchor path exports the retained max span in its stats:
        # the same shrink (layer buckets are few {1,2,4,8,...}, so the
        # compiled-program family stays tiny)
        layers = min(layers,
                     _bucket_layers(anchors.device_occ.max_span - 1))
    tables = build_solver_tables(graph, anchors, opt.recombination, layers)
    best = _solve_and_decode(graph, tables, anchors, opt)
    best_bound = best.dp_objective
    rounds = opt.lagrangian_rounds
    tol = gap_tol(opt.recombination)
    if best.true_objective - best_bound <= tol or rounds <= 0:
        best.dp_objective = best_bound
        return best

    n_kmer_ids = int(anchors.occ_kmer.max()) + 1 if len(anchors.occ_kmer) else 0
    mu = np.ones(n_kmer_ids, np.float32)
    best_mu = mu  # multipliers achieving best_bound (branch-and-bound root)
    relax_path = best  # the relaxation argmin path under the current mu
    stall = 0
    escalated = False
    it = -1
    while it + 1 < rounds:
        it += 1
        # covered-occurrence multiplicity per k-mer on the relaxation path
        covered = np.zeros(len(anchors.occ_hap), bool)
        for (sh, sq, sp) in relax_path.segments:
            covered |= ((anchors.occ_hap == sh) & (anchors.occ_start >= sq)
                        & (anchors.occ_end <= sp))
        mult = np.bincount(anchors.occ_kmer[covered], minlength=n_kmer_ids)
        dup = mult >= 2
        release = (mult == 0) & (mu < 1.0)
        if not dup.any() and not release.any():
            break
        # k-mers duplicated on the argmin path: for this fixed path the
        # dual-optimal multiplier is exactly 0 (their L-contribution is
        # mu*(1-mult) <= -mu) — jump there (coordinate ascent); released
        # k-mers (no longer covered at all) ascend back by a Polyak step
        mu[dup] = 0.0
        if release.any():
            g = np.zeros(n_kmer_ids)
            g[release] = -1.0
            step = max(best.true_objective - best_bound, 0.1) / float(release.sum())
            mu = np.clip(mu - step * g, 0.0, 1.0).astype(np.float32)
        anchors_w = dataclasses.replace(
            anchors, occ_weight=mu[anchors.occ_kmer])
        tables = build_solver_tables(graph, anchors_w, opt.recombination,
                                     layers)
        cand = _solve_and_decode(graph, tables, anchors_w, opt)
        relax_path = cand
        improved = cand.dp_objective > best_bound + 1e-6
        if improved:
            best_mu = mu.copy()
        best_bound = max(best_bound, cand.dp_objective)
        if cand.true_objective < best.true_objective - 1e-6:
            best = cand
            improved = True
        if best.true_objective - best_bound <= tol:
            break
        stall = 0 if improved else stall + 1
        if stall >= 3:
            if escalated or best.true_objective - best_bound <= tol:
                break
            # escalation 1: the gap is still open — double the multiplier
            # budget once and keep ascending (stalls are often plateaus
            # between release/re-cover phases, not true fixpoints)
            escalated = True
            rounds += max(rounds, 4)
            stall = 0
            plog.log("ILP_function",
                     f"Gap {best.true_objective - best_bound:.3f} > "
                     f"{tol:g} after {it + 1} rounds; escalating to {rounds}")
    if best.true_objective - best_bound > tol:
        # escalation 2: exact enumeration when the expanded graph is small
        # (the reference would hand this to Gurobi, which is exact at any
        # size, ILP_index.cpp:1413-1418; here small cases get the oracle)
        cand = _exact_small_case(graph, anchors, opt)
        if cand is not None:
            exact_obj, exact_res = cand
            if exact_res.true_objective < best.true_objective:
                best = exact_res
            best_bound = max(best_bound, exact_obj)
            plog.log("ILP_function",
                     f"Exact small-case enumeration closed the gap: "
                     f"optimum {exact_obj:.3f}")
    if best.true_objective - best_bound > tol and n_kmer_ids:
        # escalation 2.5: projected Polyak subgradient ascent on the full
        # dual (all coordinates, g_i = 1 - covered multiplicity) — the
        # jump/release heuristic above moves in {0, 1} steps and stalls on
        # fractional dual optima; this phase converges toward max_mu L(mu)
        best_mu, best_bound, best = _subgradient_phase(
            graph, anchors, opt, layers, best_mu, best_bound, best, tol)
    if best.true_objective - best_bound > tol:
        # escalation 3: exact Lagrangian branch-and-bound on duplicate
        # k-mer credit (solve/bnb.py), rooted at the refined multipliers —
        # works at any scale, one DP solve per node
        import os as _os2
        from phi_tpu.solve.bnb import branch_and_bound
        bb_best, bb_bound = branch_and_bound(
            graph, anchors, opt, tol,
            mu=best_mu if n_kmer_ids else None, incumbent=best,
            max_nodes=int(_os2.environ.get("PHI_TPU_BNB_NODES", "48")),
            max_seconds=float(_os2.environ.get("PHI_TPU_BNB_SECS", "120")),
            layers=layers)
        if bb_best.true_objective < best.true_objective:
            best = bb_best
        best_bound = max(best_bound, bb_bound)
        plog.log("ILP_function",
                 f"Branch-and-bound: bound {bb_bound:.3f}, incumbent "
                 f"{best.true_objective:.3f}, gap "
                 f"{max(0.0, best.true_objective - best_bound):.3f}")
    best.dp_objective = best_bound
    return best


def _subgradient_phase(graph: PangenomeGraph, anchors, opt: Options,
                       layers, mu0: np.ndarray, best_bound: float, best,
                       tol: float, max_iters: int = 40):
    """Projected subgradient ascent on the Lagrangian dual from mu0:
    g_i = 1 - (covered multiplicity of k-mer i on the relaxation argmin),
    Polyak step (UB - L)/||g||^2 with backoff on stall. Returns
    (best_mu, best_bound, best incumbent)."""
    import os
    max_iters = int(os.environ.get("PHI_TPU_SUBGRAD_ITERS", max_iters))
    mu = mu0.astype(np.float64).copy()
    best_mu = mu0
    lam = 1.0
    stall = 0
    n_kmer_ids = len(mu)
    for _ in range(max_iters):
        anchors_w = dataclasses.replace(
            anchors, occ_weight=mu.astype(np.float32)[anchors.occ_kmer])
        tables = build_solver_tables(graph, anchors_w, opt.recombination,
                                     layers)
        cand = _solve_and_decode(graph, tables, anchors_w, opt)
        improved = cand.dp_objective > best_bound + 1e-6
        if improved:
            best_bound = cand.dp_objective
            best_mu = mu.astype(np.float32).copy()
        if cand.true_objective < best.true_objective - 1e-6:
            best = cand
        if best.true_objective - best_bound <= tol:
            break
        covered = np.zeros(len(anchors.occ_hap), bool)
        for (sh, sq, sp) in cand.segments:
            covered |= ((anchors.occ_hap == sh)
                        & (anchors.occ_start >= sq)
                        & (anchors.occ_end <= sp))
        mult = np.bincount(anchors.occ_kmer[covered],
                           minlength=n_kmer_ids)
        g = 1.0 - mult.astype(np.float64)
        gnorm = float((g * g).sum())
        if gnorm <= 0:
            break
        step = lam * max(best.true_objective - cand.dp_objective, 0.05) \
            / gnorm
        mu = np.clip(mu + step * g, 0.0, 1.0)
        stall = 0 if improved else stall + 1
        if stall >= 6:
            lam *= 0.5
            stall = 0
            if lam < 1e-3:
                break
    return best_mu, best_bound, best


# expanded-graph size caps under which exhaustive enumeration is cheap
# (<~1 s; path count is bounded by states * branching along switch edges)
_EXACT_MAX_STATES = 3000
_EXACT_MAX_EDGES = 6000


def _exact_small_case(graph: PangenomeGraph, anchors: AnchorTables,
                      opt: Options):
    """Brute-force the expanded graph when it is small enough; returns
    (exact objective, DecodeResult-shaped path) or None if infeasible."""
    from phi_tpu.solve.exact import brute_force_optimum
    from phi_tpu.solve.prep import solver_layers
    tables = build_solver_tables(graph, anchors, opt.recombination,
                                 solver_layers(graph, opt.k))
    H, P = tables.state_vertex.shape
    if H * P > _EXACT_MAX_STATES or len(tables.esrc_h) > _EXACT_MAX_EDGES:
        return None
    try:
        exact, segs = brute_force_optimum(graph, tables, anchors)
    except RuntimeError:  # too many paths
        return None
    if segs is None:
        return None
    from phi_tpu.solve.decode import result_from_segments
    return exact, result_from_segments(graph, tables, anchors, segs, exact)
