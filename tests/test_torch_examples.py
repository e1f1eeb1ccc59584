"""The port's examples run on the CPU with few steps and tasks:
``examples/pt_train_lm.py`` (train, "restart", resume),
``examples/pt_serve_cluster.py`` (a healthy phase, edge-1 dies, the
traffic drains), ``examples/pt_quickstart.py`` (features, predictors,
QLMIO against the baselines) and ``examples/pt_serve_continuum.py``
(all-cloud and QLMIO replays over live engines, a streamed request).
The replay's parity with the JAX package is held by
test_torch_cluster.py and test_torch_sim.py."""
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


def test_pt_quickstart_runs_the_pipeline():
    out = _run("pt_quickstart.py", "--device", "cpu", "--tasks", "60",
               "--episodes", "4", "--epochs", "1", "--users", "5",
               "--trials", "1")
    assert "MIOBench: {'n_tasks': 60" in out
    assert "MILP  val MAE" in out and "MGQP  val acc" in out
    assert "QLMIO  : {'avg_reward'" in out
    for name in ("all_cloud", "greedy", "random"):
        assert f"         {name}" in out


def test_pt_serve_continuum_replays_both_policies():
    out = _run("pt_serve_continuum.py", "--device", "cpu", "--users", "3")
    for name in ("all_cloud", "qlmio"):
        assert f"[{name}] mean e2e" in out
    assert "completion 1.00" in out or "completion 0." in out
    assert out.count("    cloud-0 (rtx5090/llama3.2-3b): {") == 1
    assert "(first)" in out and "(final)" in out
    assert "streamed ttft" in out
