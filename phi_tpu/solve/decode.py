"""Backtrace of the converged DP and exact re-scoring of the decoded path.

Mirrors the reference's solution decode (ILP_index.cpp:1432-1581): recover
the (vertex, lane) path, count recombinations, verify every consecutive pair
is a real graph edge (hard error otherwise, :1553-1575), and additionally
re-score the path under the *exact* distinct-kmer objective so the gap to the
DP bound is reported (the reference's z_i counts each spectrum k-mer once).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phi_tpu.anchors.join import AnchorTables
from phi_tpu.graph.pangenome import PangenomeGraph
from phi_tpu.solve.prep import SolverTables

_EPS = 1e-3


@dataclasses.dataclass
class DecodeResult:
    segments: list[tuple[int, int, int]]  # (hap, start_pos, end_pos) in path order
    vertices: np.ndarray                  # int32 full vertex path
    vertex_hap: np.ndarray                # int32 lane label per path vertex
    n_switches: int                       # R-charged switch edges used
    recombination_count: int              # hap-label changes (report metric)
    matched_distinct: int                 # distinct model k-mers covered
    matched_total: float                  # weighted occurrences covered (DP credit)
    dp_objective: float                   # lower bound from the DP
    true_objective: float                 # exact objective of this path
    n_sweeps: int


def decode_path(graph: PangenomeGraph, t: SolverTables, anchors: AnchorTables,
                M: np.ndarray, ends: np.ndarray, n_sweeps: int,
                dp_objective: float) -> DecodeResult:
    import os as _os
    import time as _time
    _prof = _os.environ.get("PHI_TPU_DECODE_PROF") == "1"
    _marks: list[tuple[str, float]] = []

    def _mark(label):
        if _prof:
            _marks.append((label, _time.perf_counter()))
    _t0 = _time.time()
    _mark("start")
    H, P = t.state_vertex.shape
    walk_len = t.walk_len
    INF = np.float32(np.inf)
    # device-resident mode (dp.DeviceSolution, duck-typed): ent comes
    # precomputed on the device and switch-source exit values are fetched
    # lazily per visited vertex — the full M plane never leaves the device
    dev_sol = hasattr(M, "sv_at")
    if not dev_sol:
        M = np.asarray(M)

    # entry values (replay one numpy sweep from the fixpoint). Switch-source
    # exit values D[h,p] = M[h,p] - B[h,p] are gathered at the esrc states
    # only — the dense [H,P] D array is never built (and B itself is read
    # through the lazy point accessor; the exact path carries no dense B).
    # sort + reduceat instead of np.minimum.at (which is unbuffered and
    # orders of magnitude slower at tens of millions of source states).
    ent = np.full(t.n_vtx, INF, np.float32)
    sv = None
    if len(t.esrc_h):
        # esrc_target is graph-static: cache its sort across decode calls
        # (Lagrangian rounds re-decode with identical switch sources)
        tcache = getattr(graph, "_esrc_torder", None)
        if tcache is None or tcache[0] is not t.esrc_target:
            order = np.argsort(t.esrc_target, kind="stable")
            tcache = (t.esrc_target, order)
            graph._esrc_torder = tcache
        order = tcache[1]
        tgt_s = t.esrc_target[order]
        if dev_sol:
            ent = M.ent
        else:
            eh = t.esrc_h.astype(np.int64)
            ep = t.esrc_p.astype(np.int64)
            sv = np.where(ep < walk_len[t.esrc_h],
                          M[eh, ep] - _b_at_esrc(t, graph, eh, ep), INF)
            sv_s = sv[order]
            starts = np.flatnonzero(
                np.concatenate([[True], tgt_s[1:] != tgt_s[:-1]]))
            ent[tgt_s[starts]] = np.minimum.reduceat(sv_s, starts)

    # lane arrays (A, running minimum, rightmost-argmin, start entry) are
    # built lazily per visited lane: the backtrace touches n_switches+1
    # lanes, a handful out of H — building the dense [H,P] stack is several
    # seconds of pure wasted bandwidth at the 49-hap x 254k-position scale
    cols1d = np.arange(P)
    lane_cache: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray, float]] = {}

    def lane_arrays(h: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
        got = lane_cache.get(h)
        if got is None:
            row_valid = cols1d < walk_len[h]
            sv_row = t.state_vertex[h]
            e_row = np.where(sv_row >= 0,
                             ent[np.maximum(sv_row, 0)] + t.R, INF)
            start_entry_h = float(e_row[0])
            e_row[0] = min(e_row[0], np.float32(0.0))
            A_row = np.where(row_valid, e_row + t.S_row(h), INF)
            run_min_row = np.minimum.accumulate(A_row)
            qlatest_row = np.maximum.accumulate(
                np.where(A_row <= run_min_row, cols1d, -1))
            got = (A_row, run_min_row, qlatest_row, start_entry_h)
            lane_cache[h] = got
        return got

    L = t.n_layers if t.n_layers is not None else 0

    if L > 0:
        # lazy straddle queries: the W stack is L*H*P floats and only a few
        # backtrace states ever read it — index occurrences per lane by
        # start position instead. The (hap, start) sort depends only on the
        # occurrence LAYOUT (refinement rounds swap occ_weight, never the
        # occ_hap/occ_start arrays) — cache it across decode calls.
        ocache = getattr(graph, "_occ_sorder", None)
        if (ocache is None or ocache[0] is not t.occ_hap
                or ocache[1] is not t.occ_start):
            o_order = np.argsort(t.occ_hap.astype(np.int64) * (P + 1)
                                 + t.occ_start, kind="stable")
            ocache = (t.occ_hap, t.occ_start, o_order)
            graph._occ_sorder = ocache
        o_order = ocache[2]
        o_hap = t.occ_hap[o_order]
        o_start = t.occ_start[o_order].astype(np.int64)
        o_end = t.occ_end[o_order].astype(np.int64)
        o_w = t.occ_weight[o_order].astype(np.float64)
        hap_off = np.searchsorted(o_hap, np.arange(H + 1))

    def straddle_at(h: int, p: int) -> np.ndarray:
        """[L] vector: W[j, h, p] = weight of occurrences with
        s <= p-j-1, e >= p+1 in lane h (spans <= L+1 bound the s range)."""
        lo, hi = hap_off[h], hap_off[h + 1]
        s = o_start[lo:hi]
        a = np.searchsorted(s, p - L - 1)
        b = np.searchsorted(s, p, side="left")
        sel_e = o_end[lo + a:lo + b]
        keep = sel_e >= p + 1
        ss = s[a:b][keep]
        ww = o_w[lo + a:lo + b][keep]
        cw = np.concatenate([[0.0], np.cumsum(ww)])
        idx = np.searchsorted(ss, p - np.arange(L) - 1, side="right")
        return cw[idx]

    def entry_for(h: int, p: int) -> int:
        """Entry position achieving M[h,p]. Bracket mode: rightmost running
        minimum. Exact mode: the best of the L recent-entry candidates
        (A[q] - W[p-q, p]) and the q <= p-L prefix branch."""
        A_row, run_min_row, qlatest_row, _ = lane_arrays(h)
        if L == 0:
            return int(qlatest_row[p])
        Wv = straddle_at(h, p)
        best_v, best_q = np.inf, -1
        for j in range(min(L, p + 1)):
            cv = A_row[p - j] - Wv[j]
            if cv < best_v - 1e-9:
                best_v, best_q = cv, p - j
        if p - L >= 0 and run_min_row[p - L] < best_v - 1e-9:
            return int(qlatest_row[p - L])
        return best_q

    # CSR over esrc_target for switch-source lookup (reuses the sort above)
    if len(t.esrc_h):
        tgt_sorted = tgt_s
    else:
        order = np.zeros(0, np.int64)
        tgt_sorted = np.zeros(0, np.int32)
        sv = np.zeros(0, np.float32)

    _mark("ent+caches")
    h = int(np.argmin(ends))
    p = int(walk_len[h]) - 1
    segments: list[tuple[int, int, int]] = []
    edges_used: list[int] = []
    for _ in range(P * H + 1):
        q = entry_for(h, p)
        if q < 0:
            raise RuntimeError(
                f"backtrace: no entry point found for lane {h} position {p}")
        segments.append((h, q, p))
        v = int(t.state_vertex[h, q])
        A_row, _, _, start_entry_h = lane_arrays(h)
        entry_val = A_row[q] - t.S_row(h)[q]
        if q == 0 and entry_val >= -_EPS and start_entry_h >= -_EPS:
            break  # lane start
        # switch: find an achieving diverging source state for vertex v
        lo = np.searchsorted(tgt_sorted, v, side="left")
        hi_i = np.searchsorted(tgt_sorted, v, side="right")
        cand = order[lo:hi_i]
        vals = M.sv_at(cand) if dev_sol else sv[cand]
        j = int(np.argmin(vals))
        if not vals[j] <= ent[v] + _EPS:
            raise RuntimeError(
                f"backtrace: switch source mismatch at vertex {v} "
                f"(best source {vals[j]:.4f} > entry {ent[v]:.4f})")
        sel = cand[j]
        edges_used.append(int(t.esrc_edge[sel]))
        h, p = int(t.esrc_h[sel]), int(t.esrc_p[sel])
    else:
        raise RuntimeError("backtrace did not terminate")
    _mark("backtrace")
    segments.reverse()
    edges_used.reverse()

    # full vertex path + lane labels
    vparts, hparts = [], []
    for (sh, sq, sp) in segments:
        vparts.append(t.state_vertex[sh, sq:sp + 1])
        hparts.append(np.full(sp - sq + 1, sh, dtype=np.int32))
    vertices = np.concatenate(vparts).astype(np.int32)
    vertex_hap = np.concatenate(hparts)

    _mark("path-build")
    _verify_edges(graph, vertices)
    _mark("verify")

    n_switches = len(segments) - 1
    recomb = int((vertex_hap[1:] != vertex_hap[:-1]).sum())

    matched_distinct, matched_total = _score_matches(t, anchors, segments)
    true_obj = t.R * n_switches + (anchors.n_model_kmers - matched_distinct)
    _mark("score")
    if _prof and _marks:
        import sys as _sys
        parts = [f"{lbl}={t1 - t0:.3f}" for (_, t0), (lbl, t1)
                 in zip(_marks, _marks[1:])]
        _sys.stderr.write("[decode-prof] " + " ".join(parts) + "\n")

    from phi_tpu.solve.dp import LAST_TIMINGS
    LAST_TIMINGS["decode"] = round(
        LAST_TIMINGS.get("decode", 0.0) + (_time.time() - _t0), 3)
    return DecodeResult(
        segments=segments, vertices=vertices, vertex_hap=vertex_hap,
        n_switches=n_switches, recombination_count=recomb,
        matched_distinct=matched_distinct, matched_total=matched_total,
        dp_objective=dp_objective, true_objective=float(true_obj),
        n_sweeps=n_sweeps,
    )


def result_from_segments(graph: PangenomeGraph, t: SolverTables,
                         anchors: AnchorTables,
                         segments: list[tuple[int, int, int]],
                         dp_objective: float) -> DecodeResult:
    """DecodeResult from an externally supplied expanded-graph path (the
    exact small-case enumeration); same edge verification and exact
    scoring as the backtrace path."""
    vparts, hparts = [], []
    for (sh, sq, sp) in segments:
        vparts.append(t.state_vertex[sh, sq:sp + 1])
        hparts.append(np.full(sp - sq + 1, sh, dtype=np.int32))
    vertices = np.concatenate(vparts).astype(np.int32)
    vertex_hap = np.concatenate(hparts)
    _verify_edges(graph, vertices)
    n_switches = len(segments) - 1
    matched_distinct, matched_total = _score_matches(t, anchors, segments)
    true_obj = t.R * n_switches + (anchors.n_model_kmers - matched_distinct)
    return DecodeResult(
        segments=list(segments), vertices=vertices, vertex_hap=vertex_hap,
        n_switches=n_switches,
        recombination_count=int((vertex_hap[1:] != vertex_hap[:-1]).sum()),
        matched_distinct=matched_distinct, matched_total=matched_total,
        dp_objective=dp_objective, true_objective=float(true_obj),
        n_sweeps=0,
    )


def _b_at_esrc(t: SolverTables, graph: PangenomeGraph, eh: np.ndarray,
               ep: np.ndarray) -> np.ndarray:
    """t.B_at over the switch-source points, which are graph-static: the
    query sort is cached on the graph and the lookup is an O(n+m)
    two-pointer merge instead of millions of cold binary searches."""
    if t.B is not None:
        return t.B[eh, ep]
    keys, cumw, base, span = t.b_cache()
    qkey = (eh * span + ep).view(np.uint64)  # non-negative: reinterpret
    cache = getattr(graph, "_esrc_qorder", None)
    if cache is None or cache[0] is not t.esrc_h or cache[1] != int(span):
        order = np.argsort(qkey, kind="stable")
        cache = (t.esrc_h, int(span), order, qkey[order])
        graph._esrc_qorder = cache
    _, _, order, qsorted = cache
    try:
        from phi_tpu.native import merge_upper_native
        idx = merge_upper_native(keys.view(np.uint64), qsorted)
    except Exception:
        idx = None
    if idx is None:
        return t.B_at(eh, ep)
    tmp = np.empty(len(qkey), np.float64)
    tmp[order] = cumw[idx]
    return (tmp - cumw[base[eh]]).astype(np.float32)


def _verify_edges(graph: PangenomeGraph, vertices: np.ndarray) -> None:
    """Reference verifies each consecutive pair is a graph edge and exits
    on violation (ILP_index.cpp:1553-1575). Vectorized membership test
    against the sorted packed edge list."""
    if len(vertices) < 2:
        return
    packed_edges = getattr(graph, "_packed_edges_sorted", None)
    if packed_edges is None:  # graph-static: sort once across decode calls
        packed_edges = np.sort(graph.edge_u.astype(np.int64) << 32
                               | graph.edge_v.astype(np.int64))
        graph._packed_edges_sorted = packed_edges
    pairs = vertices[:-1].astype(np.int64) << 32 | vertices[1:].astype(np.int64)
    idx = np.searchsorted(packed_edges, pairs)
    idx_c = np.minimum(idx, len(packed_edges) - 1)
    ok = (idx < len(packed_edges)) & (packed_edges[idx_c] == pairs)
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise RuntimeError(
            f"decoded path uses non-edge {vertices[i]}->{vertices[i + 1]}")


def _score_matches(t: SolverTables, anchors: AnchorTables,
                   segments: list[tuple[int, int, int]]) -> tuple[int, float]:
    """Occurrences fully contained in an in-lane segment; distinct k-mers and
    weighted totals."""
    if len(anchors.occ_hap) == 0:
        return 0, 0.0
    covered = np.zeros(len(anchors.occ_hap), bool)
    for (sh, sq, sp) in segments:
        m = (anchors.occ_hap == sh) & (anchors.occ_start >= sq) & (anchors.occ_end <= sp)
        covered |= m
    matched_distinct = len(np.unique(anchors.occ_kmer[covered]))
    matched_total = float(anchors.occ_weight[covered].sum())
    return matched_distinct, matched_total
