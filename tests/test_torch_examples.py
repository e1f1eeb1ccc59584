"""The port's examples run on the CPU with few steps and tasks:
``examples/pt_train_lm.py`` (train, "restart", resume) and
``examples/pt_serve_cluster.py`` (a healthy phase, edge-1 dies, the
traffic drains)."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args) -> str:
    out = subprocess.run([sys.executable, f"examples/{script}", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_pt_train_lm_resumes():
    out = _run("pt_train_lm.py", "--device", "cpu", "--steps", "8",
               "--batch", "2", "--seq", "32", "--ckpt-every", "2")
    assert "[train] resumed from step 4" in out
    assert "final loss" in out


def test_pt_serve_cluster_drains_the_failed_server():
    out = _run("pt_serve_cluster.py", "--device", "cpu", "--healthy", "4",
               "--after", "6")
    assert "phase 2: edge-1 dies mid-run" in out
    assert "fault tolerance OK" in out
    assert "dispatch counts: [" in out and out.count("  task ") == 10
