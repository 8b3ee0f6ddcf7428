"""Small synthetic instances for compile checks, dryruns, and tests."""

from __future__ import annotations

import numpy as np

from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
from phi_tpu.graph import tensorize
from phi_tpu.io.build import build_gfa_data
from phi_tpu.io.gfa import encode_seq
from phi_tpu.sketch.minimizer import sketch_read_batch
from phi_tpu.solve.prep import build_solver_tables


_SEGMENTS = {
    "X": "ACGTTGCA", "A1": "TACCA", "B1": "AGGAT",
    "Y": "CAGTCAGT", "A2": "CTTCC", "B2": "GAACT",
    "Z": "TGCATGCA",
}
_WALKS = [("hapA.0", ["X", "A1", "Y", "A2", "Z"]),
          ("hapB.0", ["X", "B1", "Y", "B2", "Z"])]
_READS = [
    _SEGMENTS["X"] + _SEGMENTS["A1"] + _SEGMENTS["Y"],
    _SEGMENTS["Y"] + _SEGMENTS["B2"] + _SEGMENTS["Z"],
    _SEGMENTS["A1"] + _SEGMENTS["Y"] + _SEGMENTS["B2"],
    _SEGMENTS["X"] + _SEGMENTS["B1"] + _SEGMENTS["Y"] + _SEGMENTS["A2"],
]


def tiny_instance(k: int = 4, w: int = 2, R: float = 1.0):
    """Two-hap two-site mosaic graph + reads; returns
    (graph, reads_codes, read_lengths, spectrum, anchors, tables)."""
    graph = tensorize(build_gfa_data(_SEGMENTS, _WALKS))
    reads = _READS
    max_len = max(len(r) for r in reads)
    codes = np.full((len(reads), max_len), 4, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_seq(r)
        lengths[i] = len(r)
    spectrum = sketch_read_batch(codes, k, w, lengths)
    sketches = sketch_haplotypes(graph, k, w)
    anchors = build_anchor_tables(graph, k, sketches, spectrum, 1.0)
    tables = build_solver_tables(graph, anchors, R)
    return graph, codes, lengths, spectrum, anchors, tables


def write_tiny_instance(directory: str) -> tuple[str, str]:
    """The tiny_instance graph and reads as files: (GFA path, FASTA path)."""
    import os

    from phi_tpu.io.gfa import write_gfa
    gfa = os.path.join(directory, "tiny.gfa")
    reads = os.path.join(directory, "tiny_reads.fa")
    write_gfa(build_gfa_data(_SEGMENTS, _WALKS), path=gfa)
    with open(reads, "w") as f:
        for i, r in enumerate(_READS):
            f.write(f">tiny_read{i}\n{r}\n")
    return gfa, reads
