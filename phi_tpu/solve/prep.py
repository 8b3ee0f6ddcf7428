"""Host-side preparation of the solver's dense tables.

Encodes the reference's expanded graph (ILP_index.cpp:1160-1409) as flat
arrays over lane states (h, p):
  - switch edges exist per graph edge (u,v) from every lane h through u whose
    next vertex in h is not v (exactly when the reference adds an in-edge to
    w_{u,v}, ILP_index.cpp:1250-1279), into every lane through v (out-edges
    :1281-1302), at total cost R;
  - in-lane edges are consecutive walk positions (cost 0).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from phi_tpu.anchors.join import AnchorTables, credit_arrays
from phi_tpu.graph.pangenome import PangenomeGraph, ragged_arange


@dataclasses.dataclass
class SolverTables:
    # Dense credit arrays are None on the exact single-chip path: the device
    # builds its own S/B/W from the occurrence columns (solve.dp._build_sbw_jit)
    # and the decode backtrace reads lanes lazily (B_at / S_row below), so
    # the 2*H*P host floats would be pure wasted bandwidth at scale. Bracket
    # mode and the mesh-sharded path materialize them via dense().
    S: np.ndarray | None      # float32 [H, P] entry charge (starts < p)
    B: np.ndarray | None      # float32 [H, P] exit reward (ends <= p)
    esrc_h: np.ndarray        # int32 [n_src] lane of diverging source state
    esrc_p: np.ndarray        # int32 [n_src] position of source state
    esrc_target: np.ndarray   # int32 [n_src] target vertex of the graph edge
    esrc_edge: np.ndarray     # int32 [n_src] graph edge id (decode/report)
    state_vertex: np.ndarray  # int32 [H, P] (= walk_mat, -1 pad)
    walk_len: np.ndarray      # int32 [H]
    R: float
    const: float              # sum of occurrence-kmer weights (Σ_i mu_i)
    n_vtx: int
    # Exact-credit correction layer count (None -> bracket-DP fallback):
    # the straddle stack W[j, h, p] = weight of occurrences with
    # start < p-j <= p < end (still open at p for an entry j back). With
    # n_layers >= max_span - 1, the per-visit credit
    #   C(q,p) = B[p] - S[q]            for q <= p - L   (S charge is exact)
    #   C(q,p) = B[p] - S[q] + W[p-q,p] for q >  p - L   (recent entries)
    # equals the exact covered-occurrence weight, so the DP value IS the
    # local-credit relaxation optimum (valid bound AND optimal search).
    # W itself is never materialized on host (it is L*H*P floats): the
    # solver builds it on device from the occurrence arrays below, and the
    # decode backtrace queries straddle values lazily.
    n_layers: int | None = None
    # Slim occurrence copies (weighted) for the device W build and the
    # decode's lazy straddle queries:
    occ_hap: np.ndarray | None = None     # int32 [n_occ]
    occ_start: np.ndarray | None = None   # int32 [n_occ]
    occ_end: np.ndarray | None = None     # int32 [n_occ]
    occ_weight: np.ndarray | None = None  # float32 [n_occ]
    # Device-resident occurrence columns (anchors/device.py): when set,
    # the solver feeds S/B/W straight from these — no host pad, no upload.
    # Tuple (dev_hap u8, dev_s i32, dev_span u8, dev_w f32, Nb).
    occ_dev: tuple | None = None

    @property
    def H(self) -> int:
        return self.state_vertex.shape[0]

    @property
    def P(self) -> int:
        return self.state_vertex.shape[1]

    def dense(self) -> "SolverTables":
        """Tables with dense S/B materialized (self if already dense)."""
        if self.S is not None:
            return self
        from phi_tpu.anchors.join import credit_arrays_from_occ
        S, B = credit_arrays_from_occ(self.occ_hap, self.occ_start,
                                      self.occ_end, self.occ_weight,
                                      self.H, self.P)
        return dataclasses.replace(self, S=S, B=B)

    def b_cache(self):
        """(keys, cumw, base, span): occurrences sorted by (lane, end) with
        prefix-summed weights — the lazy-B lookup structure."""
        cache = getattr(self, "_b_sorted", None)
        if cache is None:
            span = np.int64(self.P) + 1
            key = self.occ_hap.astype(np.int64) * span + self.occ_end
            order = np.argsort(key, kind="stable")
            keys = key[order]
            cumw = np.concatenate(
                [[0.0], np.cumsum(self.occ_weight[order], dtype=np.float64)])
            base = np.searchsorted(keys, np.arange(self.H, dtype=np.int64) * span)
            cache = (keys, cumw, base, span)
            self._b_sorted = cache
        return cache

    def B_at(self, h: np.ndarray, p: np.ndarray) -> np.ndarray:
        """B values at scattered (lane, position) points — from the dense
        array when present, else by binary search over occurrences sorted by
        (lane, end) with prefix-summed weights."""
        if self.B is not None:
            return self.B[h, p]
        keys, cumw, base, span = self.b_cache()
        q = np.asarray(h, np.int64) * span + np.asarray(p, np.int64)
        idx = np.searchsorted(keys, q, side="right")
        return (cumw[idx] - cumw[base[np.asarray(h)]]).astype(np.float32)

    def S_row(self, h: int) -> np.ndarray:
        """One lane's dense S row (entry charge, starts < p)."""
        if self.S is not None:
            return self.S[h]
        cache = getattr(self, "_s_rows", None)
        if cache is None:
            cache = {}
            self._s_rows = cache
        row = cache.get(h)
        if row is None:
            P = self.P
            m = self.occ_hap == h
            start_next = self.occ_start[m].astype(np.int64) + 1
            keep = start_next < P
            diff = np.bincount(start_next[keep],
                               weights=self.occ_weight[m][keep], minlength=P)
            row = np.cumsum(diff[:P], dtype=np.float64).astype(np.float32)
            cache[h] = row
        return row


def switch_sources(graph: PangenomeGraph) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(esrc_h, esrc_p, esrc_target, esrc_edge): one row per (edge, diverging
    source lane). Lanes whose next vertex equals the edge target may not pay
    into the switch vertex (they must take the free in-lane edge instead)."""
    H, P = graph.walk_mat.shape
    lov = graph.lanes_of_vertex
    u_e, v_e = graph.edge_u, graph.edge_v
    # Edge pre-filter: a lane through u diverges from (u, v) iff its next
    # vertex != v. Walks are graph paths, so at an out-degree-1 vertex with
    # no lane ending there every lane continues along the single edge —
    # zero rows. That's the whole linear backbone: the expansion below then
    # touches only variant-adjacent edges (~3-6x fewer rows at MHC scale).
    odeg = np.bincount(u_e, minlength=graph.n_vtx)
    has_end = np.zeros(graph.n_vtx, bool)
    ends = graph.walk_mat[np.arange(H), np.maximum(graph.walk_len - 1, 0)]
    has_end[ends[graph.walk_len > 0]] = True
    active = np.flatnonzero((odeg[u_e] > 1) | has_end[u_e]).astype(np.int32)
    u_a, v_a = u_e[active], v_e[active]
    # int32 throughout: the expansion is millions of rows and these passes
    # are memory-bandwidth-bound; H*P and row counts are < 2^31
    counts = (lov.off[u_a + 1] - lov.off[u_a]).astype(np.int32)
    rep = np.repeat(np.arange(len(u_a), dtype=np.int32), counts)
    idx = np.repeat(lov.off[u_a].astype(np.int32), counts) \
        + ragged_arange(counts, np.int32)
    flat = lov.values[idx]
    sh, sp = np.divmod(flat, P)
    sh = sh.astype(np.int32, copy=False)
    sp = sp.astype(np.int32, copy=False)
    # next vertex in lane (or -1 at lane end — lane ends always diverge,
    # matching `index == paths[h].size()-1` in ILP_index.cpp:1255)
    next_vtx = np.full((H, P), -1, dtype=np.int32)
    next_vtx[:, :-1] = graph.walk_mat[:, 1:]
    diverge = next_vtx[sh, sp] != v_a[rep]
    return (sh[diverge], sp[diverge],
            v_a[rep[diverge]].astype(np.int32),
            active[rep[diverge]].astype(np.int32))


_esrc_lock = threading.Lock()
_first_occ_cache: tuple | None = None


_esrc_content_cache: tuple | None = None  # single slot: (fingerprint, rows)


def _esrc_fingerprint(graph: PangenomeGraph):
    """Content fingerprint of everything switch_sources reads. None above
    the size gate (hashing a chromosome-scale walk_mat costs ~0.3 s and
    the cached rows would hold ~1 GB of host RAM)."""
    import os
    import zlib
    gate_mb = int(os.environ.get("PHI_TPU_ESRC_CACHE_MB", "512"))
    wm = graph.walk_mat
    if wm.nbytes > gate_mb << 20:
        return None
    parts = []
    for a in (wm, graph.walk_len, graph.edge_u, graph.edge_v):
        b = np.ascontiguousarray(a)
        parts += [zlib.crc32(b), zlib.adler32(b)]
    return (graph.n_vtx,) + wm.shape + tuple(parts)


def switch_sources_cached(graph: PangenomeGraph):
    """switch_sources depends only on the graph; cache it on the instance so
    Lagrangian refinement rounds never
    recompute the tens-of-millions-row expansion. A content-keyed single
    slot additionally survives re-tensorization (warm re-runs on the same
    input rebuild the graph object; the expansion is identical)."""
    global _esrc_content_cache
    cached = getattr(graph, "_esrc_cache", None)
    if cached is None:
        with _esrc_lock:
            cached = getattr(graph, "_esrc_cache", None)
            if cached is None:
                fp = _esrc_fingerprint(graph)
                slot = _esrc_content_cache
                if fp is not None and slot is not None and slot[0] == fp:
                    cached = slot[1]
                else:
                    cached = switch_sources(graph)
                    if fp is not None:
                        _esrc_content_cache = (fp, cached)
                graph._esrc_cache = cached
    return cached


def _bucket_layers(n: int) -> int:
    """Layer counts bucketed to {0, 1, 2, 4, 8, ...} so one compiled solver
    program covers a span family (extra zero layers are mathematically
    inert: W_j == 0 for j >= max_span - 1)."""
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b *= 2
    return b


# Above this many correction layers the W stack would dominate memory
# (L * H * P floats); fall back to the bracket DP (valid bound + heuristic
# search, DESIGN.md). Spans this long only arise from pathological chains of
# zero-length nodes.
MAX_LAYERS = 64


def straddle_layers_from_occ(occ_hap, occ_start, occ_end, occ_weight,
                             H: int, P: int, n_layers: int) -> np.ndarray:
    """W[j, h, p] = total weight of occurrences with s < p-j <= p < e,
    for j in [0, n_layers). Built as per-layer difference arrays: occurrence
    [s, e] contributes to W_j over p in [s+1+j, e-1]. Host-side builder for
    the sharded path and parity tests; the single-chip solver builds W on
    device (solve.dp._build_sbw_jit)."""
    W = np.zeros((n_layers, H, P), np.float32)
    if n_layers == 0 or len(occ_hap) == 0:
        return W
    span = (occ_end - occ_start).astype(np.int64)
    hap = occ_hap.astype(np.int64)
    s64 = occ_start.astype(np.int64)
    e64 = occ_end.astype(np.int64)
    w = occ_weight.astype(np.float32)
    for j in range(n_layers):
        sel = span >= j + 2  # need s+1+j <= e-1
        if not sel.any():
            break
        lo = hap[sel] * P + (s64[sel] + 1 + j)
        hi = hap[sel] * P + e64[sel]  # exclusive end of the p-range
        diff = np.bincount(lo, weights=w[sel], minlength=H * P)
        diff -= np.bincount(hi, weights=w[sel], minlength=H * P + 1)[:H * P]
        W[j] = np.cumsum(diff.reshape(H, P).astype(np.float32),
                         axis=1, dtype=np.float32)
        # ranges never cross lane boundaries: s+1+j <= e-1 < walk_len <= P
        # and both endpoints live in lane `hap`, so the row cumsum is exact
    return W


def straddle_layers(graph: PangenomeGraph, t: AnchorTables,
                    n_layers: int) -> np.ndarray:
    H, P = graph.walk_mat.shape
    return straddle_layers_from_occ(t.occ_hap, t.occ_start, t.occ_end,
                                    t.occ_weight, H, P, n_layers)


def max_kmer_span(graph: PangenomeGraph, k: int) -> int:
    """Upper bound on occ_end - occ_start for any k-mer anchor: the worst
    case starts at the last base of a node. Graph-only (no anchors), so the
    solver's W-layer count — and hence its compiled program shape — is known
    right after graph load and stable across read sets."""
    cache = getattr(graph, "_span_cache", None)
    if cache is None:
        cache = {}
        graph._span_cache = cache
    if k in cache:
        return cache[k]
    m = 1
    for h in range(graph.num_walks):
        cl = graph.walk_node_cumlen[h]
        n = len(cl) - 1
        if n <= 0:
            continue
        last_base = cl[1:] - 1  # last base offset of each node
        e_idx = np.searchsorted(cl, last_base + k - 1, side="right") - 1
        e_idx = np.minimum(e_idx, n - 1)
        m = max(m, int((e_idx - np.arange(n)).max()))
    cache[k] = m
    return m


def solver_layers(graph: PangenomeGraph, k: int) -> int:
    """Bucketed W-layer count for this (graph, k); values above MAX_LAYERS
    make build_solver_tables fall back to the bracket DP."""
    return _bucket_layers(max_kmer_span(graph, k) - 1)


def build_solver_tables(graph: PangenomeGraph, anchors: AnchorTables,
                        R: float, n_layers: int | None = None,
                        const_override: float | None = None) -> SolverTables:
    """n_layers: W-layer count override (pipeline passes solver_layers() so
    the program shape is stable across Lagrangian rounds and read sets);
    default derives it from the anchors actually present. const_override:
    explicit Σ_i mu_i constant — the branch-and-bound zeroes individual
    occurrence weights, which must not perturb the per-k-mer constant."""
    esrc_h, esrc_p, esrc_target, esrc_edge = switch_sources_cached(graph)
    dev = getattr(anchors, "device_occ", None)
    if anchors.occ_kmer is None and dev is not None:
        # device-resident anchors, weights all 1.0: const = Σ_i mu_i over
        # distinct model k-mers = n_model_kmers; occ host columns arrive
        # later (materialize_device before decode/refinement)
        if n_layers is not None and n_layers > MAX_LAYERS:
            n_layers = None
        return SolverTables(
            S=None, B=None, esrc_h=esrc_h, esrc_p=esrc_p,
            esrc_target=esrc_target, esrc_edge=esrc_edge,
            state_vertex=graph.walk_mat, walk_len=graph.walk_len,
            R=float(R), const=float(anchors.n_model_kmers),
            n_vtx=graph.n_vtx, n_layers=n_layers,
            occ_dev=(dev.dev_hap, dev.dev_s, dev.dev_span, dev.dev_w,
                     dev.Nb))
    # const term: each model k-mer contributes weight mu_i (occ_weight is
    # per-occurrence but equal across occurrences of a k-mer). The first-
    # occurrence index depends only on occ_kmer, which refinement rounds
    # share by identity — cache it
    if const_override is not None:
        const = float(const_override)
    elif len(anchors.occ_kmer):
        global _first_occ_cache
        if _first_occ_cache is None or _first_occ_cache[0] is not anchors.occ_kmer:
            _, first = np.unique(anchors.occ_kmer, return_index=True)
            _first_occ_cache = (anchors.occ_kmer, first)
        const = float(anchors.occ_weight[_first_occ_cache[1]].sum())
    else:
        const = 0.0
    if n_layers is None:
        max_span = int((anchors.occ_end - anchors.occ_start).max()) \
            if len(anchors.occ_hap) else 1
        n_layers = _bucket_layers(max_span - 1)
    if n_layers > MAX_LAYERS:
        n_layers = None
    # dense S/B only for bracket mode (the exact path builds them on device
    # and decodes lazily — see the SolverTables docstring)
    S = B = None
    if n_layers is None:
        S, B = credit_arrays(graph, anchors)
    return SolverTables(
        S=S, B=B, esrc_h=esrc_h, esrc_p=esrc_p,
        esrc_target=esrc_target, esrc_edge=esrc_edge,
        state_vertex=graph.walk_mat, walk_len=graph.walk_len,
        R=float(R), const=const, n_vtx=graph.n_vtx, n_layers=n_layers,
        occ_hap=anchors.occ_hap, occ_start=anchors.occ_start,
        occ_end=anchors.occ_end, occ_weight=anchors.occ_weight,
        # refinement rounds over device-built anchors keep the device
        # index columns (same order as the materialized host arrays) and
        # upload only the fresh occ_weight
        occ_dev=(dev.dev_hap, dev.dev_s, dev.dev_span, dev.dev_w, dev.Nb)
        if dev is not None else None,
    )
