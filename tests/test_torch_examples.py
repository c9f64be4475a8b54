"""The port's examples run to their own asserts on the CPU, each in a
subprocess with a timeout: ``quickstart_torch.py`` (13 frequent
subgraphs on the paper's toy DB, the engine agreeing with ``mine_host``),
``mine_distributed_torch.py`` (two gloo ranks under
``torch.distributed.run``: a run cut at level 2, then a resumed run with
more levels whose frequent set equals ``mine_host``) and
``serve_lm_torch.py`` (prefill + cached greedy decode, every family
with its stub media)."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_on_the_cpu():
    out = _run("quickstart_torch.py", "--device", "cpu")
    assert "paper toy DB: 13 frequent subgraphs" in out
    assert "distributed MIRAGE on cpu agrees with the sequential baseline" \
        in out
    assert "frequent set and supports equal mine_host" in out


def test_mine_distributed_crash_and_resume_on_two_gloo_ranks(tmp_path):
    out = _run("mine_distributed_torch.py", "--device", "cpu", "--workers",
               "2", "--ckpt-dir", str(tmp_path / "ckpt"), "--timeout", "240",
               "--group-timeout", "60")
    assert out.count("backend gloo, device cpu") == 4   # 2 ranks x 2 runs
    assert "checkpoints on disk: ['step_0000000002']" in out
    assert "levels before crash: [22, 13]  -> after resume: [22, 13, 14]" \
        in out
    assert "resumed run equals mine_host" in out
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma2-2b",
                                  "deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
                                  "xlstm-1.3b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_serve_lm_on_the_cpu(arch):
    out = _run("serve_lm_torch.py", "--device", "cpu", "--arch", arch)
    assert f"=== prefill 4x16 on {arch} (reduced, cpu) ===" in out
    assert "greedy generations (token ids), shape (4, 24):" in out
    assert "serving pipeline OK (prefill -> cached decode x23)" in out
