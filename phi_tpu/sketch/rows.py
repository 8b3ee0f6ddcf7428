"""Batched sketch+join stage of the device anchor path, in plain jnp/lax.

One call covers a batch of R rows. A row is one superchunk of one
haplotype: up to `row_windows` minimizer windows plus a halo. Lane j of a
row holds base `start - 1 + j`, so lane 0 is the left halo and window lane
j is window `start - 1 + j`; the row's windows are lanes 1..nv. Lane 0's
window is the one the row's first window dedups against when the row
continues a haplotype (`cont`), so no state crosses rows, batches or
blocks: every row is computed on its own, and XLA may split the work in
any order.

Per row, in one jitted program:
  * canonical 2-bit k-mer packing (min of forward and reverse complement,
    compared on the big-endian packing; 2 words for k <= 31, 4 for
    31 < k <= 63 — word i holds 16 consecutive bases, bit-identical to the
    native 128-bit layout),
  * window-of-w minimum by sparse-table doubling (rightmost on ties),
  * dedup emit against the previous window's selection,
  * the walk-position interval of every k-mer: node index at its first and
    last base, from a per-row cumsum over node-start marks, packed as
    (walk_pos << 6) | span,
  * left compaction of the emitted lanes into [R, emitcap],
  * the spectrum probe (cuckoo table, or the mixed-key bucketed search when
    no cuckoo table could be built) and the flat hit columns the device
    accumulator appends.

Semantics equal the host path (native scan + join) on N-free sequences,
which are the only ones the device path takes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

ROW_WINDOWS = 1 << 21   # windows per row (2,097,152)
HALO = 128              # extra lanes: 1 left + k + w - 2 right, so k + w <= 129
ROWS = 8                # rows per dispatch
UMAX = np.uint32(0xFFFFFFFF)


def row_lanes(row_windows: int = ROW_WINDOWS) -> int:
    """Bases (lanes) a row holds; a multiple of 16 for the 2-bit upload."""
    assert row_windows % 16 == 0, row_windows
    return row_windows + HALO


def fits(k: int, w: int) -> bool:
    """Whether a row's halo covers the k-mer and window span."""
    return k + w - 1 <= HALO


def join_caps(w: int, row_windows: int = ROW_WINDOWS,
              rows_per_call: int = ROWS) -> tuple[int, int]:
    """(emitcap, cap_total): per-row compacted emissions and per-batch
    flat hits. 1.3x headroom over the ~2/(w+1) expected minimizer density
    (repeats only ever lower the dedup-emission density); overflows are
    detected from the exact counts and rerouted to the host path."""
    emitcap = max(1024, 13 * row_windows // (5 * (w + 1)) + 64)
    cap_total = 1 << max(15, (2 * rows_per_call * row_windows // (w + 1))
                         .bit_length())
    return emitcap, cap_total


# ---- host-side packing --------------------------------------------------

def pack_rows_2bit(seqs, rows, lanes: int) -> np.ndarray:
    """[R, lanes/16] uint32 words: 16 bases per word, base b at bits 2b.
    Row (si, start, nv, cont) holds bases start-1 .. start-1+lanes-1 of
    seqs[si]; lane 0 of a haplotype's first row (start == 0) and lanes past
    the sequence end are 0 (masked as invalid windows). Codes must be < 4:
    callers route N-containing sequences to the host join."""
    R = len(rows)
    buf = np.zeros((R, lanes), np.uint8)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si < 0:
            continue  # dummy pad row
        lo = max(start - 1, 0)
        seg = seqs[si][lo:start - 1 + lanes]
        at = lo - (start - 1)
        buf[j, at:at + len(seg)] = seg
    assert buf.max(initial=0) < 4, "pack_rows_2bit requires ACGT codes (<4)"
    c = buf.reshape(R, lanes // 16, 16)
    out = np.zeros((R, lanes // 16), np.uint32)
    for b in range(16):
        out |= c[:, :, b].astype(np.uint32) << np.uint32(2 * b)
    return out


def pack_row_starts(cumlens, rows, lanes: int, S_cap: int) -> np.ndarray:
    """[R, S_cap] int32: per-row node-start offsets relative to the row's
    first window base (>= 1: side='right' skips a boundary AT the start),
    padded with `lanes` (dropped on device)."""
    buf = np.full((len(rows), S_cap), lanes, np.int32)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si < 0:
            continue
        cl = cumlens[si]
        lo = np.searchsorted(cl, start, side="right")
        hi = np.searchsorted(cl, start + lanes - 1)
        buf[j, :hi - lo] = (cl[lo:hi] - start).astype(np.int32)
    return buf


def row_start_cap(cumlens, rows, lanes: int) -> int:
    """Max node-start count over the rows, pow2-bucketed (>= 1024)."""
    mx = 1
    for (si, start, nv, cont) in rows:
        if si < 0:
            continue
        cl = cumlens[si]
        mx = max(mx, int(np.searchsorted(cl, start + lanes - 1)
                         - np.searchsorted(cl, start, side="right")))
    return 1 << max(10, int(mx - 1).bit_length())


def row_base_nodes(cumlens, rows) -> np.ndarray:
    """Walk position (node index) of each row's first window base."""
    out = np.zeros(len(rows), np.int32)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si >= 0:
            out[j] = np.searchsorted(cumlens[si], start, side="right") - 1
    return out


# ---- the stage ----------------------------------------------------------

def _shl(x, s: int):
    """x[:, j] <- x[:, j + s], zero-filled on the right."""
    if s == 0:
        return x
    return jnp.concatenate(
        [x[:, s:], jnp.zeros((x.shape[0], s), x.dtype)], axis=1)


def _shr1(x):
    """x[:, j] <- x[:, j - 1], zero-filled on the left."""
    return jnp.concatenate(
        [jnp.zeros((x.shape[0], 1), x.dtype), x[:, :-1]], axis=1)


def _key_lt_eq(a, b):
    """(a < b, a == b) for keys given as tuples of u32 words, most
    significant first."""
    lt = jnp.zeros(a[0].shape, bool)
    eq = jnp.ones(a[0].shape, bool)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt, eq


def _tuple_min(a, b, n_words: int):
    """Min of (key words..., pos, passenger) tuples; equal keys -> larger
    pos (the reference's rightmost-on-ties window rule)."""
    lt, eq = _key_lt_eq(a[:n_words], b[:n_words])
    take_a = lt | (eq & (a[n_words] >= b[n_words]))
    return tuple(jnp.where(take_a, x, y) for x, y in zip(a, b))


def canonical_words(c, k: int):
    """Canonical k-mer key at every lane of c ([R, L] uint32 codes < 4), as
    a tuple of u32 words, most significant first: 2 words for k <= 31, 4
    for 31 < k <= 63. Lanes within k - 1 of the end read zero fill."""
    n_words = 2 if k <= 31 else 4
    cs = [_shl(c, j) for j in range(k)]
    fw = [jnp.zeros_like(c) for _ in range(n_words)]
    rw = [jnp.zeros_like(c) for _ in range(n_words)]
    two = jnp.uint32(2)
    for j in range(k):
        wi = (k - 1 - j) // 16
        fw[wi] = (fw[wi] << two) | cs[j]
        rw[wi] = (rw[wi] << two) | (jnp.uint32(3) - cs[k - 1 - j])
    fwd = tuple(reversed(fw))
    rev = tuple(reversed(rw))
    lt, eq = _key_lt_eq(fwd, rev)
    f_le = lt | eq
    return tuple(jnp.where(f_le, f, r) for f, r in zip(fwd, rev))


def sketch_rows(words, starts, nvalid, cont, base_node, k: int, w: int):
    """Window selections of a batch of rows: (emit [R, L] bool, key words
    tuple, packed interval [R, L] u32), lanes as in the module docstring."""
    R, n_w = words.shape
    L = n_w * 16
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    c = ((words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(3)
         ).reshape(R, L)
    key = canonical_words(c, k)
    n_words = len(key)
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, L), 1)
    rowi = jax.lax.broadcasted_iota(jnp.int32, starts.shape, 0)
    # node index at every base: base_node plus the node starts at or before
    # it (a start offset o marks lane o + 1)
    marks = jnp.zeros((R, L), jnp.int32).at[rowi, starts + 1].add(
        1, mode="drop")
    node = base_node[:, None] + jnp.cumsum(marks, axis=1)
    span = jnp.minimum(_shl(node, k - 1) - node, 63)
    packed = (node.astype(jnp.uint32) << jnp.uint32(6)) \
        | span.astype(jnp.uint32)

    t = key + (lane, packed)
    s = 1
    while 2 * s <= w:
        t = _tuple_min(t, tuple(_shl(v, s) for v in t), n_words)
        s *= 2
    t = _tuple_min(t, tuple(_shl(v, w - s) for v in t), n_words)
    sel = t[:n_words]

    nv = nvalid[:, None]
    valid = (lane >= 1) & (lane <= nv)
    prev_valid = ((lane >= 2) & (lane <= nv + 1)) \
        | ((lane == 1) & (cont[:, None] != 0))
    differs = jnp.zeros((R, L), bool)
    for x in sel:
        differs = differs | (x != _shr1(x))
    emit = valid & (~prev_valid | differs)
    return emit, sel, t[n_words + 1]


def _compact(emit, vals, emitcap: int):
    """Left-compact the emitted lanes of each row into [R, emitcap]
    (UMAX-filled past the count; overflow lanes dropped)."""
    R = emit.shape[0]
    order = jnp.cumsum(emit.astype(jnp.int32), axis=1) - 1
    dst = jnp.where(emit & (order < emitcap), order, emitcap)
    rowi = jax.lax.broadcasted_iota(jnp.int32, emit.shape, 0)
    return tuple(jnp.full((R, emitcap), UMAX, jnp.uint32)
                 .at[rowi, dst].set(v, mode="drop") for v in vals)


def flatten_hits(n_min, found, idx, ese, hap_of_row, cap_total: int):
    """Row-major flattening of the hit columns (packed interval, probe
    index, hap) into [cap_total] arrays."""
    hit = found & (ese != UMAX)
    n_hit = hit.sum(axis=1)
    base = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(n_hit).astype(jnp.int32)[:-1]])
    horder = jnp.cumsum(hit.astype(jnp.int32), axis=1) - 1 + base[:, None]
    hdst = jnp.where(hit, jnp.minimum(horder, cap_total), cap_total).ravel()
    hap_b = jnp.broadcast_to(hap_of_row[:, None], ese.shape)

    def flat(vals, fill):
        return jnp.full((cap_total + 1,), fill, vals.dtype) \
            .at[hdst].set(vals.ravel(), mode="drop")[:cap_total]

    return (n_min, n_hit, flat(ese, UMAX),
            flat(idx.astype(jnp.int32), -1), flat(hap_b, -1))


def probe_and_flatten(n_min, key, ese, hap_of_row, sp, probe: str,
                      cap_total: int):
    """Spectrum probe of compacted keys + hit flattening. `sp` is the
    cuckoo table (Thi, Tlo, Tid, seed) or the mixed-key table (m, lo,
    perm, off, rounds). Wide keys (4 words) are folded to the host's 64-bit
    join key first; dead lanes are masked through ese == UMAX."""
    from phi_tpu.ops.search import pair_isin_cuckoo_slot, pair_isin_mixed
    q_hi, q_lo = key if len(key) == 2 else fold128_64_u32(*key)
    if probe == "cuckoo":
        Thi, Tlo, Tid, seed = sp
        found, slot = pair_isin_cuckoo_slot(Thi, Tlo, seed, q_hi, q_lo)
        nm, nh, f_se, f_slot, f_hap = flatten_hits(
            n_min, found, slot, ese, hap_of_row, cap_total)
        # slot -> spectrum id: one gather on [cap_total]
        f_id = jnp.where(f_slot >= 0, Tid[jnp.maximum(f_slot, 0)],
                         jnp.int32(-1))
        return nm, nh, f_se, f_id, f_hap
    m, lo, perm, off, rounds = sp
    bits = (off.shape[0] - 1).bit_length() - 1
    found, idx = pair_isin_mixed(m, lo, perm, off, q_hi, q_lo, rounds, bits)
    return flatten_hits(n_min, found, idx, ese, hap_of_row, cap_total)


@functools.partial(jax.jit, static_argnames=(
    "k", "w", "emitcap", "cap_total", "probe"))
def join_rows(words, starts, nvalid, cont, base_node, hap_of_row, sp,
              k: int, w: int, emitcap: int, cap_total: int,
              probe: str = "cuckoo"):
    """One batch of the fused sketch+join: (n_min [R], n_hit [R],
    f_se/f_id/f_hap [cap_total]). n_min is exact even when a row's
    emissions exceed emitcap (the caller detects that and reroutes)."""
    emit, key, packed = sketch_rows(words, starts, nvalid, cont, base_node,
                                    k, w)
    n_min = emit.sum(axis=1).astype(jnp.int32)
    comp = _compact(emit, key + (packed,), emitcap)
    return probe_and_flatten(n_min, comp[:-1], comp[-1], hap_of_row, sp,
                             probe, cap_total)


# ---- u32-limb emulation of the 64-bit fold (phi_native.cpp::fold128_64,
# encode.fold128_64_np) — elementwise on the compacted lanes ----

def _mul32_full(a, b):
    """(hi, lo) of a*b for u32 lanes (16-bit limb products)."""
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> jnp.uint32(16)
    b0 = b & jnp.uint32(0xFFFF)
    b1 = b >> jnp.uint32(16)
    p0 = a0 * b0
    p1 = a1 * b0
    p2 = a0 * b1
    p3 = a1 * b1
    mid = p1 + p2
    carry_mid = (mid < p1).astype(jnp.uint32)
    lo = p0 + (mid << jnp.uint32(16))
    carry_lo = (lo < p0).astype(jnp.uint32)
    hi = p3 + (mid >> jnp.uint32(16)) + (carry_mid << jnp.uint32(16)) \
        + carry_lo
    return hi, lo


def _mul64_lo(ah, al, bh, bl):
    """Low 64 bits of (ah:al) * (bh:bl), as (hi, lo) u32 words."""
    hi, lo = _mul32_full(al, bl)
    hi = hi + al * bh + ah * bl
    return hi, lo


def _xor_shr64(h, l, s: int):
    """(h:l) ^ ((h:l) >> s) for 0 < s < 32."""
    sh = jnp.uint32(s)
    inv = jnp.uint32(32 - s)
    return h ^ (h >> sh), l ^ ((l >> sh) | (h << inv))


def _mix64_u32(h, l):
    """splitmix64 finalizer on (hi, lo) u32 pairs (encode.mix64_np twin)."""
    h, l = _xor_shr64(h, l, 30)
    h, l = _mul64_lo(h, l, jnp.uint32(0xBF58476D), jnp.uint32(0x1CE4E5B9))
    h, l = _xor_shr64(h, l, 27)
    h, l = _mul64_lo(h, l, jnp.uint32(0x94D049BB), jnp.uint32(0x133111EB))
    return _xor_shr64(h, l, 31)


def fold128_64_u32(w3, w2, w1, w0):
    """64-bit join key (hi, lo u32) of a 4-word canonical packing —
    bit-identical to fold128_64_np((w3<<32)|w2, (w1<<32)|w0)."""
    mh, ml = _mix64_u32(w1, w0)
    gh, gl = _mul64_lo(w3, w2, jnp.uint32(0x9E3779B9), jnp.uint32(0x7F4A7C15))
    return _mix64_u32(gh ^ mh, gl ^ ml)
