"""Index checkpointing and the benchmark matrix runner."""

import numpy as np

from phi_tpu.checkpoint import load_index, save_index
from phi_tpu.config import Options
from phi_tpu.eval.batch import run_matrix, write_matrix_csv


def test_index_checkpoint_roundtrip(tmp_path):
    spectrum = (np.arange(5, dtype=np.uint32), np.arange(5, dtype=np.uint32) * 3)
    hits = [(7, np.array([1, 2], np.int32), np.array([0, 4], np.int32)),
            (9, np.zeros(0, np.int32), np.zeros(0, np.int32))]
    p = tmp_path / "index.npz"
    save_index(str(p), spectrum, hits, meta={"k": 31, "w": 25})
    sp2, hits2, meta = load_index(str(p))
    assert np.array_equal(sp2[0], spectrum[0])
    assert np.array_equal(sp2[1], spectrum[1])
    assert hits2[0][0] == 7 and hits2[1][0] == 9
    assert np.array_equal(hits2[0][1], hits[0][1])
    assert int(meta["k"]) == 31


def test_run_matrix_toy(tmp_path):
    from phi_tpu.testing import write_tiny_instance
    gfa, _ = write_tiny_instance(str(tmp_path))
    truth = tmp_path / "truth.fa"
    # truth = walk hapB.0; reads are one copy of it
    hap_b = "ACGTTGCAAGGATCAGTCAGTGAACTTGCATGCA"
    truth.write_text(f">t\n{hap_b}\n")
    reads = tmp_path / "reads.fa"
    reads.write_text(f">r1\n{hap_b}\n")
    opt = Options(k=4, w=2, recombination=1.0)
    cells = [("toy", "1x", str(reads), str(truth))]
    res = run_matrix(gfa, cells, opt,
                     out_csv=str(tmp_path / "out.csv"), target_runs=2)
    assert len(res) == 1
    assert res[0].edit_distance == 0
    csv_text = (tmp_path / "out.csv").read_text()
    assert "Reads" in csv_text and "toy" in csv_text


def test_checkpoint_suffix_normalized(tmp_path):
    from phi_tpu.checkpoint import load_index, save_index
    sp = (np.array([1, 2], np.uint32), np.array([3, 4], np.uint32))
    hits = [(5, np.array([0], np.int32), np.array([1], np.int32))]
    base = str(tmp_path / "idx")  # no .npz suffix
    save_index(base, sp, hits)
    sp2, hits2, _ = load_index(base)
    assert np.array_equal(sp2[0], sp[0]) and hits2[0][0] == 5


def test_downsample_fastq(tmp_path):
    import gzip

    from phi_tpu.eval.batch import downsample_fastq
    src = tmp_path / "r.fq.gz"
    with gzip.open(src, "wt") as f:
        for i in range(400):
            f.write(f"@r{i}\nACGTACGTAC\n+\nIIIIIIIIII\n")
    out = tmp_path / "s.fq.gz"
    kept = downsample_fastq(str(src), str(out), 0.25, seed=3)
    assert 50 <= kept <= 150  # ~100 expected
    with gzip.open(out, "rt") as f:
        lines = f.read().strip().split("\n")
    assert len(lines) == 4 * kept
    assert lines[0].startswith("@r") and lines[1] == "ACGTACGTAC"
