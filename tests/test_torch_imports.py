"""The port stands alone: importing every ``repro_torch`` module, and
``chip_smoke.py``, pulls in neither JAX nor the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c",
                          _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert bad.strip() == "[]"
    assert int(n) == len(list(PKG.rglob("*.py")))    # every module


def test_trainer_modules_import_no_jax_and_no_reference():
    """The trainer (``repro_torch.training.*``, ``launch.train``, the
    sharded trainer's ``distributed.collectives``) is among the modules
    the probe imports, and alone it pulls in no JAX either."""
    names = ["repro_torch.training", "repro_torch.training.optimizer",
             "repro_torch.training.train_state", "repro_torch.training.data",
             "repro_torch.training.checkpoint", "repro_torch.training.loop",
             "repro_torch.launch.train",
             "repro_torch.distributed.collectives"]
    probe = ("import importlib, sys\n"
             f"for n in {names!r}: importlib.import_module(n)\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_port_sources_name_no_jax_or_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b"
                     r"[.\w]*\s+import)", re.M)
    files = (list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py")))
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []


def test_mesh_rank_entry_imports_no_jax_and_no_reference(tmp_path):
    """A rank of ``launch.train`` on a mesh (the entry the CLI starts once
    a rank: ``--rank`` / ``--world`` / ``--init-file``), one step of the
    smoke model in a world of one on the CPU, imports neither JAX nor the
    JAX package."""
    probe = ("import sys\n"
             "from repro_torch.launch import train\n"
             "assert train.main(['--smoke', '--device', 'cpu', '--steps', "
             "'1', '--batch', '2', '--seq', '16', '--mesh', '1x1', "
             "'--rank', '0', '--world', '1', '--init-file', "
             f"{str(tmp_path / 'store')!r}, '--checkpoint-dir', "
             f"{str(tmp_path / 'ck')!r}]) == 0\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
