"""Sketch/join throughput micro-benchmark (BASELINE.md north-star: read
k-mer throughput, k-mers/s per chip, at 1 chip / 1 host / multi-device).

Measures, on the active backend (GPU or host CPU):
  * `sketch`  — minimizer extraction over a read-shaped concatenation
                (the reference's hot loops #1/#2, ILP_index.cpp:359-493);
                reports bases/s and k-mers/s (every window position is a
                k-mer the scan evaluates);
  * `join`    — the fused sketch+join against a spectrum (hot loop #3);
  * `sketch@N`— the dp-sharded variant over an N-device mesh (the >=2-host
                analog; on CPU use XLA_FLAGS=--xla_force_host_platform_
                device_count=N).

Each metric reports the median of `repeats` warm runs with IQR and the
raw observations (first run pays compile, excluded), plus roofline
context on a GPU: the device-memory bandwidth ceiling for the stage's
input traffic and the achieved fraction. Output: one JSON line per
metric, naming the device it ran on.

    python -m phi_tpu.eval.throughput --mbases 64 --mesh 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from phi_tpu.eval.stats import summarize

# Published peak device-memory bandwidth per JAX device_kind (NVIDIA's
# data sheet: H100 SXM5 80 GB HBM3, 3.35 TB/s at its 700 W limit). A
# device that is not in the table is an error, not a default.
PEAK_MEMORY_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
SKETCH_BYTES_PER_BASE = 0.25  # 2-bit packed input; outputs are ~1e-3 of it


def _roofline(device, bases_per_s: float) -> dict:
    """Memory-bandwidth roofline of the sketch input stream; none on the
    host CPU."""
    if device.platform == "cpu":
        return {}
    try:
        peak = PEAK_MEMORY_BYTES_PER_S[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak bandwidth for {device.device_kind!r}; add "
            "it to PEAK_MEMORY_BYTES_PER_S with its source") from None
    ceiling = peak / SKETCH_BYTES_PER_BASE
    return {"mem_roofline_bases_per_s": round(ceiling),
            "mem_roofline_fraction": round(bases_per_s / ceiling, 6)}


def _rand_reads(rng: np.random.Generator, total_bases: int,
                read_len: int = 150) -> tuple[np.ndarray, np.ndarray]:
    n_reads = max(1, total_bases // read_len)
    concat = rng.integers(0, 4, n_reads * read_len, dtype=np.uint8)
    off = np.arange(n_reads + 1, dtype=np.int64) * read_len
    return concat, off


def bench_sketch(total_bases: int, k: int = 31, w: int = 25,
                 repeats: int = 5, devices=None) -> dict:
    """Read-spectrum sketch throughput (sketch_read_concat path)."""
    from phi_tpu.sketch.minimizer import sketch_read_concat
    rng = np.random.default_rng(0)
    concat, off = _rand_reads(rng, total_bases)
    hi, lo = sketch_read_concat(concat, off, k, w, devices=devices)  # compile
    times = []
    for _ in range(repeats):
        t0 = time.time()
        hi, lo = sketch_read_concat(concat, off, k, w, devices=devices)
        times.append(time.time() - t0)
    st = summarize(times)
    n_windows = len(concat) - (len(off) - 1) * (k + w - 2)  # evaluated k-mers
    return {"data": "synthetic", "metric": "sketch" if devices is None
            else f"sketch@{len(devices)}dev",
            "bases_per_s": round(len(concat) / st["median_s"]),
            "kmers_per_s": round(max(n_windows, 0) / st["median_s"]),
            "spectrum": int(len(hi)), **st}


def bench_join(total_bases: int, k: int = 31, w: int = 25,
               repeats: int = 5) -> dict:
    """Fused haplotype sketch+join throughput (one long sequence vs a
    spectrum sampled from itself — every window does the table probe)."""
    from phi_tpu.sketch.minimizer import sketch_join_many, sketch_sequence
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 4, total_bases, dtype=np.uint8)
    hi, lo, _pos = sketch_sequence(seq[: min(total_bases, 1 << 22)], k, w)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    key = np.unique(key)
    sp_hi = (key >> np.uint64(32)).astype(np.uint32)
    sp_lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sketch_join_many([seq], k, w, sp_hi, sp_lo)  # compile warmup
    times, n_hits = [], 0
    for _ in range(repeats):
        t0 = time.time()
        out = sketch_join_many([seq], k, w, sp_hi, sp_lo)
        times.append(time.time() - t0)
        n_hits = int(len(out[0][1]))
    st = summarize(times)
    return {"data": "synthetic", "metric": "join",
            "bases_per_s": round(total_bases / st["median_s"]),
            "kmers_per_s": round((total_bases - k - w + 2) / st["median_s"]),
            "hits": n_hits, **st}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-throughput")
    ap.add_argument("--mbases", type=float, default=64.0,
                    help="input size in megabases (default 64)")
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--w", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--mesh", type=int, default=0,
                    help="also run the dp-sharded sketch over N devices")
    ap.add_argument("--out", default=None, help="write JSONL artifact here")
    args = ap.parse_args(argv)
    import jax
    total = int(args.mbases * 1e6)
    rows = [bench_sketch(total, args.k, args.w, args.repeats),
            bench_join(total, args.k, args.w, args.repeats)]
    if args.mesh > 1:
        from phi_tpu.parallel.sharded import make_mesh
        devices = list(make_mesh(args.mesh).devices.reshape(-1))
        rows.append(bench_sketch(total, args.k, args.w, args.repeats,
                                 devices=devices))
    dev = jax.devices()[0]
    lines = []
    for r in rows:
        r["backend"] = dev.platform
        r["device"] = dev.device_kind
        r["device_count"] = len(jax.devices())
        r.update(_roofline(dev, r["bases_per_s"]))
        line = json.dumps(r)
        lines.append(line)
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
