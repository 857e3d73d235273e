"""The port's examples (``examples/*_torch.py``) at smoke widths on the
CPU (``--device cpu``): each exits 0 and prints what it is about — T1's
max |Δ| within its tolerance, every batched request served, the aborted
background request finishing with reason ``abort``."""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers a thread
    pool per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_example(name, capsys):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--device", "cpu"])
    return rc, capsys.readouterr().out


def test_quickstart(capsys):
    rc, out = run_example("quickstart_torch", capsys)
    assert rc == 0, out
    err = float(re.search(r"max \|Δ\| = ([0-9.e+-]+)", out).group(1))
    assert err <= 2e-2
    assert "round-trips: True" in out


def test_serve_batch(capsys):
    rc, out = run_example("serve_batch_torch", capsys)
    assert rc == 0, out
    assert re.search(r"^served 12 requests / 192 tokens", out, re.M)
    assert len(re.findall(r"^  req +\d+: \[.*\] \[length\]$", out,
                          re.M)) == 5


def test_streaming_serve(capsys):
    rc, out = run_example("streaming_serve_torch", capsys)
    assert rc == 0, out
    assert "(aborted background request 0: abort)" in out
    assert re.search(r"token\[11\] = \d+  <length>", out)
