"""The port's training CLI (``python -m repro_torch.launch.train``) and
``examples/train_tiny_lm_torch.py`` on the CPU: the CLI trains and prints
the JAX CLI's final line; SIGTERM checkpoints and exits 0, and a rerun
resumes; the mesh flags train RWKV6 as they train the dense family
(``tests/test_torch_sharded_train.py``); the example's loss falls.
"""
import os
import select
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from repro_torch.training.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_trains_and_prints_the_final_line(capsys):
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as d:
        assert train.main(["--smoke", "--steps", "3", "--device", "cpu",
                           "--batch", "2", "--seq", "32",
                           "--checkpoint-dir", d, "--log-every", "1"]) == 0
        assert CheckpointManager(d).latest_step() == 3
    out = capsys.readouterr().out
    assert "step      3  loss" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("finished at step 3 (restored_from=None, "
                           "preempted=False); loss ")
    assert "median step" in last and last.endswith("slow_steps=0")


@pytest.mark.parametrize("flags", [["--devices", "4"], ["--mesh", "2x2"],
                                   ["--grad-compression", "int8_ef"]])
def test_cli_mesh_flags_train_rwkv6(flags):
    """The mesh flags train RWKV6 as they train the dense family (TP and
    the pod hop cover every family): ``--devices 4`` and ``--mesh 2x2``
    (data 2 x model 2: FSDP and TP at once), int8-EF across two pods;
    every rank exits 0 and the last step is committed."""
    from repro_torch.launch import train
    if flags[0] == "--grad-compression":
        flags = flags + ["--mesh", "2x1x1"]   # int8-EF hops across pods
    with tempfile.TemporaryDirectory() as d:
        assert train.main(["--smoke", "--device", "cpu", "--arch",
                           "rwkv6-1.6b", "--steps", "2", "--batch", "4",
                           "--seq", "16", "--checkpoint-dir", d]
                          + flags) == 0
        assert CheckpointManager(d).latest_step() == 2


def _sigterm_then_resume(flags, rerun_flags, env=None):
    """The CLI as a subprocess with ``flags``: SIGTERM after its first
    logged step; it exits 0 with a committed step, and a rerun with
    ``rerun_flags`` resumes from it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
               "--device", "cpu", "--batch", "2", "--seq", "32",
               "--checkpoint-dir", d, "--log-every", "1"]
        proc = subprocess.Popen(cmd + flags + ["--steps", "1000"], env=env,
                                stdout=subprocess.PIPE, text=True,
                                cwd=str(ROOT))
        try:
            ready, _, _ = select.select([proc.stdout], [], [], 120)
            assert ready, "no step logged within 120 s"
            first = proc.stdout.readline()
            assert first.startswith("step      1"), first
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0
        assert "preempted=True" in out
        step = CheckpointManager(d).latest_step()
        assert step is not None and 1 <= step < 1000
        res = subprocess.run(cmd + rerun_flags + ["--steps", str(step + 2)],
                             env=env, capture_output=True, text=True,
                             timeout=120, cwd=str(ROOT))
        assert res.returncode == 0, res.stderr
        assert (f"finished at step {step + 2} (restored_from={step}, "
                "preempted=False)") in res.stdout


def test_cli_sigterm_checkpoints_exits_0_and_resumes():
    """The CLI as a subprocess: SIGTERM after its first logged step; it
    exits 0 with a committed step, and a rerun resumes from it."""
    _sigterm_then_resume([], [])


def test_cli_sigterm_on_a_mesh_resumes_at_another_mesh():
    """The same on two gloo ranks: the CLI passes SIGTERM to its ranks,
    they agree to stop and checkpoint the gathered state at (1, 2), and
    the rerun restores its shards at (2, 1)."""
    _sigterm_then_resume(["--mesh", "1x2"], ["--mesh", "2x1"],
                         env={"OMP_NUM_THREADS": "1"})


def test_example_trains_and_the_loss_falls():
    """``examples/train_tiny_lm_torch.py`` on the CPU: a few steps of the
    ~25M-param model, its loss falling (the example asserts it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_tiny_lm_torch", ROOT / "examples" / "train_tiny_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as d:
        res = mod.main(["--device", "cpu", "--steps", "8", "--ckpt", d])
    assert len(res.losses) == 8 and res.losses[-1] < res.losses[0]
