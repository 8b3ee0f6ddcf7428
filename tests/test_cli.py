"""CLI smoke tests on the tiny two-walk instance (phi_tpu.testing)."""

import os
import subprocess
import sys

from phi_tpu.testing import write_tiny_instance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SEQ = "ACGTTGCAAGGATCAGTCAGTGAACTTGCATGCA"


def _env():
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", REPO),
            "PYTHONPATH": REPO}


def test_cli_toy_run(tmp_path):
    out = tmp_path / "toy.fa"
    gfa, reads = write_tiny_instance(str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "phi_tpu.cli", "-g", gfa, "-r", reads,
         "-o", str(out), "-k", "4", "-w", "2", "-R", "1", "-d", "1"],
        capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-1500:]
    err = proc.stderr
    # [M::] phase-log contract lines (postprocessing.py scrapes these)
    assert "Indexed reads with spectrum size:" in err
    assert "Filtered/Retained Minimizers:" in err
    assert "Minimizers are in ILP" in err
    assert "Recombination count:" in err
    assert "Real time:" in err and "Peak RSS:" in err
    text = out.read_text()
    assert text == f">tiny_tiny_reads LN:{len(TINY_SEQ)}\n{TINY_SEQ}\n"


def test_cli_version():
    proc = subprocess.run(
        [sys.executable, "-m", "phi_tpu.cli", "--version"],
        capture_output=True, text=True, timeout=120,
        env=_env())
    assert proc.returncode == 0
    assert proc.stdout.startswith("PHI version:")


def test_cli_rejects_non_gfa(tmp_path):
    # note: a '>seq' header would now parse as embedded-FASTA GFA (a real
    # GFA mode, gfa-io.cpp:479-499), so use genuinely segment-less content
    bad = tmp_path / "x.gfa"
    bad.write_text("this is not a gfa file\nACGT\n")
    reads = tmp_path / "r.fa"
    reads.write_text(">r\nACGT\n")
    proc = subprocess.run(
        [sys.executable, "-m", "phi_tpu.cli", "-g", str(bad),
         "-r", str(reads), "-o", str(tmp_path / "o.fa")],
        capture_output=True, text=True, timeout=300,
        env=_env())
    assert proc.returncode == 1
    assert "[E::main]" in proc.stderr and "no segments" in proc.stderr


def test_cli_rejects_walkless_gfa(tmp_path):
    bad = tmp_path / "x.gfa"
    bad.write_text("S\ta\tACGT\nS\tb\tCCCC\nL\ta\t+\tb\t+\t0M\n")
    reads = tmp_path / "r.fa"
    reads.write_text(">r\nACGT\n")
    proc = subprocess.run(
        [sys.executable, "-m", "phi_tpu.cli", "-g", str(bad),
         "-r", str(reads), "-o", str(tmp_path / "o.fa")],
        capture_output=True, text=True, timeout=300,
        env=_env())
    assert proc.returncode == 1
    assert "W-line" in proc.stderr


def test_cli_save_and_load_index(tmp_path):
    env = _env()
    gfa, reads = write_tiny_instance(str(tmp_path))
    idx = str(tmp_path / "tiny.idx.npz")
    out1, out2 = str(tmp_path / "o1.fa"), str(tmp_path / "o2.fa")
    base = [sys.executable, "-m", "phi_tpu.cli",
            "-g", gfa, "-k", "4", "-w", "2"]
    p1 = subprocess.run(base + ["-r", reads,
                                "-o", out1, "--save-index", idx],
                        capture_output=True, text=True, timeout=300, env=env)
    assert p1.returncode == 0, p1.stderr
    assert "Index saved" in p1.stderr
    # re-solve from the index without reads (R sweep use case)
    p2 = subprocess.run(base + ["-o", out2, "--load-index", idx, "-R", "50"],
                        capture_output=True, text=True, timeout=300, env=env)
    assert p2.returncode == 0, p2.stderr
    assert "Loaded index" in p2.stderr
    seq1 = "".join(l.strip() for l in open(out1) if not l.startswith(">"))
    seq2 = "".join(l.strip() for l in open(out2) if not l.startswith(">"))
    assert seq1 == seq2 == TINY_SEQ
    # k mismatch is a clean error
    p3 = subprocess.run(base[:-4] + ["-k", "5", "-w", "2", "-o", out2,
                                     "--load-index", idx],
                        capture_output=True, text=True, timeout=300, env=env)
    assert p3.returncode == 1 and "was built with" in p3.stderr


def test_cli_debug_sharing_histogram(tmp_path):
    gfa, reads = write_tiny_instance(str(tmp_path))
    p = subprocess.run(
        [sys.executable, "-m", "phi_tpu.cli", "-g", gfa, "-r", reads,
         "-o", str(tmp_path / "o.fa"), "-k", "4", "-w", "2", "-d", "1"],
        capture_output=True, text=True, timeout=300, env=_env())
    assert p.returncode == 0, p.stderr
    assert "Shared fraction of unique kmers by haplotypes" in p.stderr
    lines = [l for l in p.stderr.splitlines()
             if l.startswith("[Haplotypes: ")]
    assert len(lines) == 2  # one row per walk count (two walks)
    fracs = [float(l.rsplit(" ", 1)[1].rstrip("]")) for l in lines]
    assert abs(sum(fracs) - 1.0) < 1e-3


def test_cli_debug_model_dump(tmp_path):
    """-d1 dumps the full dense model on toy inputs (the analog of the
    reference's printObjectiveFunction/printConstraints/printNonZeroVariables,
    ILP_index.cpp:1423-1429)."""
    gfa, reads = write_tiny_instance(str(tmp_path))
    p = subprocess.run(
        [sys.executable, "-m", "phi_tpu.cli", "-g", gfa, "-r", reads,
         "-o", str(tmp_path / "o.fa"), "-k", "4", "-w", "2", "-d", "1"],
        capture_output=True, text=True, timeout=300, env=_env())
    assert p.returncode == 0, p.stderr
    err = p.stderr
    assert "[D] objective: minimize" in err
    # one credit-table row per walk lane
    assert sum(1 for l in err.splitlines()
               if l.startswith("[D] lane ")) == 2
    # two bubbles between shared nodes: switch edges must exist
    assert any(l.startswith("[D] switch (") and "cost" in l
               for l in err.splitlines())
    # occurrence intervals (the k-mer constraint analog)
    assert any(l.startswith("[D] occ kmer=") for l in err.splitlines())
