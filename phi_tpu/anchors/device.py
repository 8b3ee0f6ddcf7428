"""Device-resident anchor pipeline: fused sketch+join -> on-device anchor
tables, with no bulk hit transfer to the host.

The haplotype join would otherwise deliver ~110 MB of raw hits to the host
at the flagship scale and rebuild the anchor tables there
(ILP_index.cpp:495-526 + :670-722 semantics). This module keeps the whole
hit stream on device:

  1. `sketch.rows.join_rows` emits per-hit walk-position intervals (s, e)
     plus spectrum ids for a batch of superchunk rows;
  2. each batch is appended to a device accumulator (`_append_jit`,
     donated buffers, device-chained offsets — no host sync);
  3. the chunked finalize reproduces the reference's threshold filter on
     device:
     group = (k-mer, vertex-run identity) via a 64-bit substring polynomial
     hash over per-lane vertex prefix tables, per-k-mer occurrence counts,
     a min==max uniformity test that resolves single-run k-mers, and an
     exact ownership-table loop for the ambiguous remainder;
  4. retained multi-vertex occurrences are compacted on device and feed the
     solver directly; a small async copy brings them to the host for
     decode / Lagrangian refinement, overlapped with the solve.

Semantics match anchors.join.anchor_tables_from_hits exactly up to the
internal group-hash function (both are 64-bit hashes of the same group
identity; decisions differ only on astronomically unlikely collisions).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from phi_tpu.graph.pangenome import PangenomeGraph

UMAX32 = jnp.uint32(0xFFFFFFFF)
# independent odd multipliers for the two polynomial prefix-hash moduli
_POLY1 = np.uint32(0x9E3779B1)
_POLY2 = np.uint32(0x85EBCA77)
_MAX_SPAN = 64            # pw table size; spans are <= k <= 31 by packing
_OWNER_ROUNDS = 16        # ownership-loop cap (expected ~3-4 rounds)


def _fmix32(x):
    """murmur3 finalizer (uint32 lanes)."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


@functools.partial(jax.jit, static_argnames=("P1", "P2"))
def _build_ph_jit(walk_mat, P1: int, P2: int):
    """Per-lane vertex-sequence prefix hashes PH[h, p] = hash of
    walk_mat[h, :p] under x -> x*POLY + (v+1) (u32 wraparound), PH[:, 0]=0.
    Substring (vertex run) hash of walk[s..e] is then
    PH[e+1] - PH[s] * POLY^(e-s+1) — exact run identity up to 2x32-bit
    collisions, the same guarantee class as the host path's u64 mix chain."""
    v = walk_mat.astype(jnp.uint32) + jnp.uint32(1)

    def scan_mod(poly):
        m = jnp.full(v.shape, jnp.uint32(poly))
        a = v

        def comb(left, right):
            ml, al = left
            mr, ar = right
            return ml * mr, al * mr + ar

        _, ph = jax.lax.associative_scan(comb, (m, a), axis=1)
        H = v.shape[0]
        return jnp.concatenate(
            [jnp.zeros((H, 1), jnp.uint32), ph], axis=1)

    return scan_mod(P1), scan_mod(P2)


def _pw_tables() -> tuple[np.ndarray, np.ndarray]:
    pw1 = np.ones(_MAX_SPAN + 2, np.uint32)
    pw2 = np.ones(_MAX_SPAN + 2, np.uint32)
    for i in range(1, _MAX_SPAN + 2):
        pw1[i] = (int(pw1[i - 1]) * int(_POLY1)) & 0xFFFFFFFF
        pw2[i] = (int(pw2[i - 1]) * int(_POLY2)) & 0xFFFFFFFF
    return pw1, pw2


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _append_jit(buf_se, buf_id, buf_hap, total, fse, fid, fhap):
    """Append one batch's flat hit columns at the device-chained offset.
    Buffers are donated (in-place update); `total` is the raw running count
    (unclamped — the caller detects overflow from the final value).
    buf_se holds the join stage's packed (walk_pos << 6) | span intervals."""
    cap = buf_se.shape[0]
    ct = fse.shape[0]
    off = jnp.minimum(total, jnp.int32(cap - ct))
    nh = jnp.sum(fid >= 0)
    buf_se = jax.lax.dynamic_update_slice(buf_se, fse, (off,))
    buf_id = jax.lax.dynamic_update_slice(buf_id, fid, (off,))
    buf_hap = jax.lax.dynamic_update_slice(
        buf_hap, jnp.maximum(fhap, 0).astype(jnp.uint8), (off,))
    return buf_se, buf_id, buf_hap, total + nh.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("tot_b",))
def _slice_jit(buf_se, buf_id, buf_hap, tot_b: int):
    return (jax.lax.dynamic_slice(buf_se, (0,), (tot_b,)),
            jax.lax.dynamic_slice(buf_id, (0,), (tot_b,)),
            jax.lax.dynamic_slice(buf_hap, (0,), (tot_b,)))


@functools.partial(jax.jit, static_argnames=("tot_b",))
def _chunk1_jit(buf, tot_b: int):
    return jax.lax.dynamic_slice(buf, (0,), (tot_b,))


@jax.jit
def _mkw_jit(c_s, n_occ):
    return (jnp.arange(c_s.shape[0], dtype=jnp.int32)
            < n_occ).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Chunked finalize: at chromosome scale the single-program filter would
# materialize ~11 occurrence-length temporaries (a compile-time
# RESOURCE_EXHAUSTED at 100 Mbp / ~280M hits). The same math runs as
# per-chunk passes with donated [Ksp]-sized accumulators:
#   pass 1 (per chunk): group hashes + ktot/umin/umax/vmin/vmax updates
#   mid    (once):      uniformity test -> kbad_uni, ambiguous k-mer set
#   pass 2a (per chunk): collect ambiguous occurrences (chained append)
#   owner  (once):      exact ownership-loop counts -> kbad
#   pass 2b (per chunk): keep/multi masks, compact retained (chained
#                        append), per-hap / model-k-mer accumulators
# ---------------------------------------------------------------------------


def _group_hashes(bufs, off, rem, ph1, ph2, pw1, pw2, Ksp, CH: int):
    """Slice one CH-row chunk out of the full accumulator buffers (fused
    into the reads by XLA — no host-side per-chunk copies) and compute the
    per-occurrence group hashes."""
    occ_se = jax.lax.dynamic_slice(bufs[0], (off,), (CH,))
    occ_id = jax.lax.dynamic_slice(bufs[1], (off,), (CH,))
    occ_hap = jax.lax.dynamic_slice(bufs[2], (off,), (CH,))
    N = CH
    Pp1 = ph1.shape[1]
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = (idx < rem) & (occ_id >= 0)
    s32 = jnp.where(valid, (occ_se >> jnp.uint32(6)).astype(jnp.int32), 0)
    span32 = jnp.where(valid, (occ_se & jnp.uint32(63)).astype(jnp.int32), 0)
    hap32 = occ_hap.astype(jnp.int32)
    kid = jnp.where(valid, occ_id, Ksp)
    base = hap32 * Pp1
    i_lo = jnp.where(valid, base + s32, 0)
    i_hi = jnp.where(valid, base + s32 + span32 + 1, 0)
    sp1 = pw1[jnp.minimum(span32 + 1, pw1.shape[0] - 1)]
    sp2 = pw2[jnp.minimum(span32 + 1, pw2.shape[0] - 1)]
    rh1 = ph1.reshape(-1)[i_hi] - ph1.reshape(-1)[i_lo] * sp1
    rh2 = ph2.reshape(-1)[i_hi] - ph2.reshape(-1)[i_lo] * sp2
    idu = occ_id.astype(jnp.uint32)
    g1 = _fmix32(rh1 ^ _fmix32(idu * jnp.uint32(0x27D4EB2F)))
    g2 = _fmix32(rh2 ^ _fmix32(idu * jnp.uint32(0x165667B1)))
    return valid, s32, span32, hap32, kid, g1, g2, occ_id, occ_hap


@functools.partial(jax.jit, static_argnames=("Ksp", "CH"),
                   donate_argnums=(9, 10, 11, 12, 13))
def _fin_pass1_jit(buf_se, buf_id, buf_hap, off, rem, ph1, ph2, pw1, pw2,
                   ktot, umin, umax, vmin, vmax, Ksp: int, CH: int):
    valid, _, _, _, kid, g1, g2, _, _ = _group_hashes(
        (buf_se, buf_id, buf_hap), off, rem, ph1, ph2, pw1, pw2, Ksp, CH)
    u = g1 ^ g2
    v = g1 + g2
    big = UMAX32
    ktot = ktot.at[kid].add(valid.astype(jnp.int32), mode="drop")
    umin = umin.at[kid].min(jnp.where(valid, u, big), mode="drop")
    umax = umax.at[kid].max(jnp.where(valid, u, jnp.uint32(0)), mode="drop")
    vmin = vmin.at[kid].min(jnp.where(valid, v, big), mode="drop")
    vmax = vmax.at[kid].max(jnp.where(valid, v, jnp.uint32(0)), mode="drop")
    return ktot, umin, umax, vmin, vmax


@functools.partial(jax.jit, static_argnames=("Ksp",))
def _fin_mid_jit(ktot, umin, umax, vmin, vmax, th, Ksp: int):
    uniform = (umin == umax) & (vmin == vmax)
    hot = (ktot.astype(jnp.float32) >= th).at[Ksp].set(False)
    kbad_uni = (uniform & hot)[:Ksp]
    k_amb = (~uniform) & hot
    # exact ambiguous-occurrence count: pass 2a collects precisely the
    # occurrences of ambiguous k-mers, so its buffers can be sized exactly
    # (the round-4 TOT//16 heuristic silently sent real-MHC runs — 18%
    # ambiguous — to the host path on every call)
    n_amb = jnp.where(k_amb, ktot, 0).sum()
    return kbad_uni, k_amb, n_amb


@functools.partial(jax.jit, static_argnames=("Ksp", "CH"),
                   donate_argnums=(10, 11, 12))
def _fin_pass2a_jit(buf_se, buf_id, buf_hap, off, rem, ph1, ph2, pw1, pw2,
                    k_amb, ag1_buf, ag2_buf, aid_buf, a_total, Ksp: int,
                    CH: int):
    valid, _, _, _, kid, g1, g2, _, _ = _group_hashes(
        (buf_se, buf_id, buf_hap), off, rem, ph1, ph2, pw1, pw2, Ksp, CH)
    amb = valid & k_amb[kid]
    n = amb.sum().astype(jnp.int32)
    N = CH
    order = jnp.cumsum(amb.astype(jnp.int32)) - 1
    dst = jnp.where(amb, jnp.minimum(order, N - 1), N - 1)
    src = jnp.full(N + 1, N, jnp.int32).at[dst].set(
        jnp.where(amb, jnp.arange(N, dtype=jnp.int32), N), mode="drop")[:N]
    cg1 = jnp.concatenate([g1, jnp.zeros(1, jnp.uint32)])[src]
    cg2 = jnp.concatenate([g2, jnp.zeros(1, jnp.uint32)])[src]
    cid = jnp.concatenate([kid, jnp.full(1, Ksp, jnp.int32)])[src]
    cap = ag1_buf.shape[0]
    off = jnp.minimum(a_total, jnp.int32(max(cap - N, 0)))
    ag1_buf = jax.lax.dynamic_update_slice(ag1_buf, cg1, (off,))
    ag2_buf = jax.lax.dynamic_update_slice(ag2_buf, cg2, (off,))
    aid_buf = jax.lax.dynamic_update_slice(aid_buf, cid, (off,))
    return ag1_buf, ag2_buf, aid_buf, a_total + n


@functools.partial(jax.jit, static_argnames=("Ksp",))
def _fin_owner_jit(ag1, ag2, aid, a_total, th, kbad_uni, Ksp: int):
    amb_cap = ag1.shape[0]
    a_live = (jnp.arange(amb_cap, dtype=jnp.int32) < a_total) & (aid < Ksp)
    AM = max(2 * amb_cap, 8)
    big = UMAX32

    def cond(st):
        unpl, gcnt, r = st
        return jnp.any(unpl) & (r < _OWNER_ROUNDS)

    def body(st):
        unpl, gcnt, r = st
        slot = (_fmix32(ag1 + r.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
                ^ ag2).astype(jnp.int32) & jnp.int32(AM - 1)
        t1 = jnp.full(AM, big, jnp.uint32).at[slot].min(
            jnp.where(unpl, ag1, big))
        cand = unpl & (t1[slot] == ag1)
        t2 = jnp.full(AM, big, jnp.uint32).at[slot].min(
            jnp.where(cand, ag2, big))
        win = cand & (t2[slot] == ag2)
        cnt_r = jnp.zeros(AM, jnp.int32).at[slot].add(win.astype(jnp.int32))
        gcnt = jnp.where(win, cnt_r[slot], gcnt)
        return unpl & ~win, gcnt, r + 1

    unpl, gcnt, rounds_used = jax.lax.while_loop(
        cond, body, (a_live, jnp.zeros(amb_cap, jnp.int32), jnp.uint32(0)))
    amb_bad = a_live & (gcnt.astype(jnp.float32) >= th)
    kbad_amb = jnp.zeros(Ksp + 1, jnp.int32).at[
        jnp.where(a_live, aid, Ksp)].max(amb_bad.astype(jnp.int32),
                                         mode="drop")
    kbad = jnp.concatenate(
        [kbad_uni | (kbad_amb[:Ksp] > 0), jnp.zeros(1, bool)])
    return kbad, jnp.any(unpl), rounds_used


@functools.partial(jax.jit, static_argnames=("Ksp", "H", "CH"),
                   donate_argnums=(10, 11, 12, 13, 15, 16))
def _fin_pass2b_jit(buf_se, buf_id, buf_hap, off, rem, ph1, ph2, pw1, pw2,
                    kbad, o_s, o_span, o_id, o_hap, o_total,
                    per_hap, kmulti, Ksp: int, H: int, CH: int):
    """Returns the updated accumulators plus this chunk's retained max
    span (host maxes across chunks for the solver's layer shrink)."""
    valid, s32, span32, hap32, kid, _, _, occ_id, occ_hap = _group_hashes(
        (buf_se, buf_id, buf_hap), off, rem, ph1, ph2, pw1, pw2, Ksp, CH)
    keep = valid & ~kbad[kid]
    per_hap = per_hap.at[jnp.where(keep, hap32, H - 1)].add(
        keep.astype(jnp.int32), mode="drop")
    multi = keep & (span32 > 0)
    kmulti = kmulti.at[kid].max(multi.astype(jnp.int32), mode="drop")
    N = CH
    n = multi.sum().astype(jnp.int32)
    order = jnp.cumsum(multi.astype(jnp.int32)) - 1
    dst = jnp.where(multi, jnp.minimum(order, N - 1), N - 1)
    src = jnp.full(N + 1, N, jnp.int32).at[dst].set(
        jnp.where(multi, jnp.arange(N, dtype=jnp.int32), N),
        mode="drop")[:N]
    c_s = jnp.concatenate([s32, jnp.zeros(1, jnp.int32)])[src]
    c_span = jnp.concatenate([span32.astype(jnp.uint8),
                              jnp.zeros(1, jnp.uint8)])[src]
    c_id = jnp.concatenate([occ_id, jnp.full(1, -1, jnp.int32)])[src]
    c_hap = jnp.concatenate([occ_hap, jnp.zeros(1, jnp.uint8)])[src]
    cap = o_s.shape[0]
    off = jnp.minimum(o_total, jnp.int32(max(cap - N, 0)))
    o_s = jax.lax.dynamic_update_slice(o_s, c_s, (off,))
    o_span = jax.lax.dynamic_update_slice(o_span, c_span, (off,))
    o_id = jax.lax.dynamic_update_slice(o_id, c_id, (off,))
    o_hap = jax.lax.dynamic_update_slice(o_hap, c_hap, (off,))
    mspan = jnp.where(multi, span32, 0).max()
    return o_s, o_span, o_id, o_hap, o_total + n, per_hap, kmulti, mspan


@functools.partial(jax.jit, static_argnames=("tot_b",))
def _fin_amb_slice_jit(ag1, ag2, aid, tot_b: int):
    return (jax.lax.dynamic_slice(ag1, (0,), (tot_b,)),
            jax.lax.dynamic_slice(ag2, (0,), (tot_b,)),
            jax.lax.dynamic_slice(aid, (0,), (tot_b,)))


@functools.partial(jax.jit, static_argnames=("Ksp",))
def _fin_tail_jit(o_total, ms_stack, unresolved, ktot, kbad, kmulti,
                  Ksp: int):
    """Combined end-of-finalize stats vector: one device->host fetch."""
    filtered = (kbad[:Ksp] & (ktot[:Ksp] > 0)).sum()
    n_model = kmulti[:Ksp].sum()
    return jnp.stack([o_total, ms_stack.max(),
                      unresolved.astype(jnp.int32),
                      filtered.astype(jnp.int32),
                      n_model.astype(jnp.int32)])


@dataclasses.dataclass
class DeviceOcc:
    """Device-resident retained occurrences + pending host copies."""
    dev_s: object            # jnp [Nb] int32 walk-position starts
    dev_span: object         # jnp [Nb] uint8
    dev_id: object           # jnp [Nb] int32 spectrum ids (-1 pad)
    dev_hap: object          # jnp [Nb] uint8
    dev_w: object            # jnp [Nb] float32 (1.0 live / 0.0 pad)
    n_occ: int
    n_model: int
    filtered: int
    per_hap_anchors: np.ndarray
    Nb: int
    max_span: int = 0       # max occ_end - occ_start among retained occ

    def start_host_copy(self) -> None:
        for a in (self.dev_s, self.dev_span, self.dev_id, self.dev_hap):
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass

    def materialize(self):
        """(occ_hap, occ_start, occ_end, occ_kmer) int32 host arrays."""
        n = self.n_occ
        s = np.asarray(self.dev_s)[:n].astype(np.int32)
        span = np.asarray(self.dev_span)[:n].astype(np.int32)
        kid = np.asarray(self.dev_id)[:n].astype(np.int32)
        hap = np.asarray(self.dev_hap)[:n].astype(np.int32)
        return hap, s, s + span, kid


def bucket_pow(n: int, minimum: int = 1 << 15) -> int:
    """{2^k, 3*2^(k-1)} bucket (same family as solve.dp.bucket_size)."""
    from phi_tpu.solve.dp import bucket_size
    return bucket_size(max(n, 1), minimum)


# Device-resident cache of packed join batches. The packed words/starts are
# pure functions of (graph content, k, w, row shape); re-runs on the same
# graph in one process (repeated runs, parameter sweeps, --load-index
# refinements) skip the host 2-bit pack AND the host->device upload.
# Content-keyed (the pipeline re-tensorizes the graph each run, so object
# identity misses); single slot (latest graph); used only while the batches
# take at most 1/32 of the device's memory.
_PACK_CACHE: dict = {}
_PACK_WORKERS = 3


def _graph_fingerprint(graph) -> tuple | None:
    """Cheap content fingerprint; None above the hashing-cost cutoff."""
    import zlib
    g = graph.gfa
    if g.seq_code.nbytes > (256 << 20):
        return None
    wm = np.ascontiguousarray(graph.walk_mat)
    nl = np.ascontiguousarray(g.node_len)
    return (zlib.crc32(g.seq_code), zlib.adler32(g.seq_code),
            zlib.crc32(wm.tobytes()), zlib.crc32(nl.tobytes()),
            graph.n_vtx, graph.num_walks,
            tuple(int(x) for x in graph.walk_len))


def _warn(msg: str) -> None:
    import sys
    sys.stderr.write(f"[W::anchors] host hit path: {msg}\n")


def join_anchors_device(graph: PangenomeGraph, seqs: list[np.ndarray],
                        k: int, w: int, sp_hi, sp_lo, threshold: float,
                        *, rows_per_call: int | None = None,
                        row_windows: int | None = None):
    """Fused device sketch+join+anchor build over all haplotypes.

    Returns (per_hap_minimizers int64 [H], DeviceOcc), or None with a
    [W::anchors] line for the documented capacity cases — N-containing
    walks, H > 255, k + w beyond the row halo, walks too short for one
    window, and emit/hit/retained cap overflow — where the caller takes the
    host hit path."""
    from concurrent.futures import ThreadPoolExecutor

    from phi_tpu.ops.search import make_cuckoo
    from phi_tpu.sketch import rows as rw
    from phi_tpu.sketch.minimizer import prepare_spectrum_bucket
    from phi_tpu.solve.dp import device_bytes_limit

    R = rows_per_call or rw.ROWS
    sup = row_windows or rw.ROW_WINDOWS
    lanes = rw.row_lanes(sup)
    H = graph.num_walks
    if H > 255:
        _warn(f"{H} haplotypes > 255 (uint8 hap column)")
        return None
    if not rw.fits(k, w):
        _warn(f"k + w - 1 = {k + w - 1} > row halo {rw.HALO}")
        return None
    halo = k + w - 2

    rows: list[tuple[int, int, int, int]] = []
    per_hap_min = np.zeros(H, np.int64)
    est_windows = 0
    for i, codes in enumerate(seqs):
        L = len(codes)
        if L < w + k - 1:
            continue
        if (codes >= 4).any():
            _warn(f"walk {graph.walk_names[i]} has non-ACGT bases")
            return None
        for start in range(0, max(1, L - halo), sup):
            nv = min(sup, L - halo - start)
            rows.append((i, start, nv, 1 if start else 0))
            est_windows += nv
    if not rows:
        _warn(f"no walk is long enough for one window (k + w - 1 = "
              f"{k + w - 1})")
        return None

    # cuckoo probe when the spectrum fits (a few gathers, no bisect rounds);
    # the mixed-key bucketed search otherwise
    ck = make_cuckoo(np.asarray(sp_hi), np.asarray(sp_lo))
    if ck is not None:
        Thi, Tlo, Tid, seed, _M = ck
        sp_args = (jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
                   jnp.uint32(seed))
        probe = "cuckoo"
    elif k > 31:
        _warn("wide k needs the cuckoo spectrum table, which could not be "
              "built")
        return None
    else:
        sp_m_np, sp_lo_np, sp_perm_np, sp_off_np, Sb, rounds, bits = \
            prepare_spectrum_bucket(sp_hi, sp_lo)
        sp_args = tuple(jnp.asarray(a) for a in
                        (sp_m_np, sp_lo_np, sp_perm_np, sp_off_np)) \
            + (jnp.int32(rounds),)
        probe = "mixed"

    cumlens = graph.walk_node_cumlen
    S_cap = rw.row_start_cap(cumlens, rows, lanes)
    emitcap, cap_total = rw.join_caps(w, sup, R)
    # hit accumulator: hits <= emitted minimizers <= ~2.6/(w+1) windows,
    # plus one batch of slack so a clamped append can never overwrite live
    # data before the overflow check fires. Chromosome-scale buffers are
    # rounded to finalize-chunk multiples so the chunked filter tiles them
    # exactly.
    import os
    CH0 = int(os.environ.get("PHI_TPU_FIN_CHUNK", _FIN_CHUNK))
    CAP = bucket_pow(int(est_windows * 2.6 / (w + 1)) + cap_total, 1 << 18)
    if CAP > CH0:
        CAP = -(-CAP // CH0) * CH0
    n_batches = -(-len(rows) // R)
    padded = rows + [(-1, 0, 0, 0)] * (n_batches * R - len(rows))

    cache_key = None
    cached_batches = None
    batch_bytes = R * (lanes // 4 + S_cap * 4)
    if n_batches * batch_bytes <= device_bytes_limit() // 32:
        fp = _graph_fingerprint(graph)
        if fp is not None:
            cache_key = fp + (k, w, R, sup, S_cap)
            hit = _PACK_CACHE.get("slot")
            if hit is not None and hit[0] == cache_key \
                    and len(hit[1]) == n_batches:
                cached_batches = hit[1]
    if cached_batches is None:
        _PACK_CACHE.pop("slot", None)  # never pin another graph's batches

    def _pack(b):
        batch = padded[b * R:(b + 1) * R]
        return (rw.pack_rows_2bit(seqs, batch, lanes),
                rw.pack_row_starts(cumlens, batch, lanes, S_cap),
                np.array([r[2] for r in batch], np.int32),
                np.array([r[3] for r in batch], np.int32),
                rw.row_base_nodes(cumlens, batch),
                np.array([max(r[0], 0) for r in batch], np.int32))

    buf_se = jnp.zeros(CAP, jnp.uint32)
    buf_id = jnp.full(CAP, -1, jnp.int32)
    buf_hap = jnp.zeros(CAP, jnp.uint8)
    total = jnp.int32(0)

    # Windowed pipeline: the host packs up to _PACK_WORKERS batches ahead
    # on threads while the device runs; batch b's counts are fetched only
    # once WINDOW later batches are enqueued, so the fetch overlaps their
    # execution instead of draining the queue.
    WINDOW = 3
    counts = np.zeros((n_batches, 2, R), np.int64)
    pend: list = [None] * n_batches
    new_cache: list = [] if (cache_key is not None
                             and cached_batches is None) else None
    packer = ThreadPoolExecutor(_PACK_WORKERS)
    try:
        futs: dict = {}
        if cached_batches is None:
            for b0 in range(min(_PACK_WORKERS, n_batches)):
                futs[b0] = packer.submit(_pack, b0)
        for b in range(n_batches):
            if cached_batches is not None:
                dev = cached_batches[b]
            else:
                dev = tuple(jax.device_put(a) for a in futs.pop(b).result())
                nb = b + _PACK_WORKERS
                if nb < n_batches:
                    futs[nb] = packer.submit(_pack, nb)
                if new_cache is not None:
                    new_cache.append(dev)
            out = rw.join_rows(*dev, sp_args, k=k, w=w, emitcap=emitcap,
                               cap_total=cap_total, probe=probe)
            for a in out[:2]:
                a.copy_to_host_async()
            buf_se, buf_id, buf_hap, total = _append_jit(
                buf_se, buf_id, buf_hap, total, out[2], out[3], out[4])
            # keep only the counts alive: the hit columns live on in the
            # accumulator after the append
            pend[b] = out[:2]
            if b >= WINDOW:
                _harvest(b - WINDOW, counts, pend)
        for b in range(max(0, n_batches - WINDOW), n_batches):
            _harvest(b, counts, pend)
    finally:
        packer.shutdown(wait=False, cancel_futures=True)

    if new_cache is not None and len(new_cache) == n_batches:
        _PACK_CACHE["slot"] = (cache_key, new_cache)

    # exact overflow checks (counts are on the host now): a row whose
    # emissions exceeded emitcap, or a batch whose hits exceeded cap_total,
    # truncated its arrays
    nmin_max = int(counts[:, 0].max(initial=0))
    if nmin_max > emitcap:
        _warn(f"emit cap overflow (max {nmin_max} > emitcap {emitcap})")
        return None
    batch_hits = counts[:, 1].sum(axis=1)
    if batch_hits.max(initial=0) > cap_total \
            or batch_hits.sum() > CAP - cap_total:
        _warn(f"hit cap overflow (batch max {int(batch_hits.max())} vs "
              f"{cap_total}, total {int(batch_hits.sum())} vs "
              f"{CAP - cap_total})")
        return None
    for b in range(n_batches):
        for j, (si, start, nv, cont) in enumerate(padded[b * R:(b + 1) * R]):
            if si >= 0:
                per_hap_min[si] += int(counts[b, 0, j])

    total_hits = int(batch_hits.sum())
    TOT = bucket_pow(total_hits + 1, 1 << 15)
    if TOT > CH0:
        TOT = -(-TOT // CH0) * CH0  # chunked finalize: tile exactly
    if TOT < CAP:
        buf_se, buf_id, buf_hap = _slice_jit(buf_se, buf_id, buf_hap,
                                             tot_b=TOT)

    # prefix-hash tables (graph-static, device-cached)
    from phi_tpu.solve.dp import _dev_cached
    Hb_, Pb_ = graph.walk_mat.shape
    wm_dev = _dev_cached(graph.walk_mat, (Hb_, Pb_, "wm_ph"),
                         lambda: jnp.asarray(graph.walk_mat))
    ph1, ph2 = _build_ph_jit(wm_dev, P1=int(_POLY1), P2=int(_POLY2))
    pw1, pw2 = _pw_tables()

    Ksp = len(sp_hi)
    fin = _finalize_chunked(buf_se, buf_id, buf_hap, total_hits, TOT,
                            ph1, ph2, pw1, pw2, threshold, Ksp, H)
    if fin is None:
        _warn("retained-occurrence cap overflow")
        return None
    c_s, c_span, c_id, c_hap, stats_np, per_hap = fin
    if stats_np[3]:
        _warn(f"unresolved ownership after {_OWNER_ROUNDS} rounds")
        return None
    n_occ = int(stats_np[0])
    # shrink the compacted columns to the retained-occurrence bucket: the
    # solver's scatter programs and the decode-side host fetch both scale
    # with this length (TOT is the raw-hit bucket, typically ~6x larger)
    cur_len = int(c_s.shape[0])
    Nb_occ = min(bucket_pow(n_occ + 1, 1 << 15), cur_len)
    if Nb_occ < cur_len:
        c_s, c_span, c_id = _slice_jit(c_s, c_span, c_id, tot_b=Nb_occ)
        c_hap = _chunk1_jit(c_hap, tot_b=Nb_occ)
    c_w = _mkw_jit(c_s, jnp.int32(n_occ))
    occ = DeviceOcc(
        dev_s=c_s, dev_span=c_span, dev_id=c_id, dev_hap=c_hap, dev_w=c_w,
        n_occ=n_occ, n_model=int(stats_np[1]),
        filtered=int(stats_np[2]),
        per_hap_anchors=np.asarray(per_hap).astype(np.int64),
        Nb=Nb_occ, max_span=int(stats_np[4]))
    return per_hap_min, occ


def _harvest(b, counts, pend):
    n_min, n_hit = pend[b]
    counts[b, 0] = np.asarray(n_min).astype(np.int64)
    counts[b, 1] = np.asarray(n_hit).astype(np.int64)


# finalize chunk length (rows). Each pass materializes a handful of
# chunk-length temporaries; 2^26 keeps that under ~2.5 GB — the
# single-program finalize at ~280M hits was a compile-time OOM.
_FIN_CHUNK = 1 << 26


def _finalize_chunked(buf_se, buf_id, buf_hap, total_hits: int, TOT: int,
                      ph1, ph2, pw1, pw2, threshold: float, Ksp: int,
                      H: int):
    """Chunked threshold filter (see the pass overview above) — the single
    finalize path at every scale (n_chunks = 1 below _FIN_CHUNK). Returns
    (c_s, c_span, c_id, c_hap, stats, per_hap) with stats a host array
    [n_occ, n_model, filtered, unresolved, max_span, n_amb], or None on
    retained-occurrence cap overflow.

    The ambiguity buffers are sized EXACTLY: pass 1's per-k-mer totals give
    n_amb = sum(ktot[k_amb]) before pass 2a allocates, so ambiguous
    overflow cannot happen."""
    import os
    CH = min(int(os.environ.get("PHI_TPU_FIN_CHUNK", _FIN_CHUNK)), TOT)
    n_chunks = -(-TOT // CH)
    if n_chunks * CH > buf_se.shape[0]:
        return None  # buffers not chunk-coverable (shouldn't happen)
    pw1_d = jnp.asarray(pw1)
    pw2_d = jnp.asarray(pw2)
    th = jnp.float32(threshold * H)
    bufs = (buf_se, buf_id, buf_hap)
    offs = [jnp.int32(c * CH) for c in range(n_chunks)]
    rems = [jnp.int32(max(0, min(total_hits - c * CH, CH)))
            for c in range(n_chunks)]
    tabs = (ph1, ph2, pw1_d, pw2_d)

    ktot = jnp.zeros(Ksp + 1, jnp.int32)
    umin = jnp.full(Ksp + 1, 0xFFFFFFFF, jnp.uint32)
    umax = jnp.zeros(Ksp + 1, jnp.uint32)
    vmin = jnp.full(Ksp + 1, 0xFFFFFFFF, jnp.uint32)
    vmax = jnp.zeros(Ksp + 1, jnp.uint32)
    for c in range(n_chunks):
        ktot, umin, umax, vmin, vmax = _fin_pass1_jit(
            *bufs, offs[c], rems[c], *tabs, ktot, umin, umax, vmin, vmax,
            Ksp=Ksp, CH=CH)
    kbad_uni, k_amb, n_amb_d = _fin_mid_jit(ktot, umin, umax, vmin, vmax,
                                            th, Ksp=Ksp)
    n_amb = int(np.asarray(n_amb_d))
    Nb_amb = bucket_pow(n_amb + 1, 1 << 14)
    amb_cap = Nb_amb + CH  # append slack: each chunk writes CH padded lanes
    ag1 = jnp.zeros(amb_cap, jnp.uint32)
    ag2 = jnp.zeros(amb_cap, jnp.uint32)
    aid = jnp.full(amb_cap, Ksp, jnp.int32)
    a_total = jnp.int32(0)
    for c in range(n_chunks):
        ag1, ag2, aid, a_total = _fin_pass2a_jit(
            *bufs, offs[c], rems[c], *tabs, k_amb, ag1, ag2, aid, a_total,
            Ksp=Ksp, CH=CH)
    if Nb_amb < amb_cap:
        ag1, ag2, aid = _fin_amb_slice_jit(ag1, ag2, aid, tot_b=Nb_amb)
    kbad, unresolved, _rounds = _fin_owner_jit(
        ag1, ag2, aid, jnp.int32(n_amb), th, kbad_uni, Ksp=Ksp)
    del ag1, ag2, aid

    occ_cap = bucket_pow(TOT // 3 + CH, 1 << 18)
    o_s = jnp.zeros(occ_cap, jnp.int32)
    o_span = jnp.zeros(occ_cap, jnp.uint8)
    o_id = jnp.full(occ_cap, -1, jnp.int32)
    o_hap = jnp.zeros(occ_cap, jnp.uint8)
    o_total = jnp.int32(0)
    per_hap = jnp.zeros(H, jnp.int32)
    kmulti = jnp.zeros(Ksp + 1, jnp.int32)
    ms_parts = []
    for c in range(n_chunks):
        o_s, o_span, o_id, o_hap, o_total, per_hap, kmulti, ms = \
            _fin_pass2b_jit(*bufs, offs[c], rems[c], *tabs, kbad, o_s,
                            o_span, o_id, o_hap, o_total, per_hap, kmulti,
                            Ksp=Ksp, H=H, CH=CH)
        ms_parts.append(ms)
    # one combined stats fetch
    tail = _fin_tail_jit(o_total, jnp.stack(ms_parts), unresolved, ktot,
                         kbad, kmulti, Ksp=Ksp)
    n_occ, mspan, unres, filtered, n_model = \
        (int(x) for x in np.asarray(tail))
    if n_occ > occ_cap - CH:
        return None
    stats_np = np.array([n_occ, n_model, filtered, unres, mspan, n_amb],
                        np.int64)
    return o_s, o_span, o_id, o_hap, stats_np, per_hap
