"""The port's examples (``examples/*_torch.py``) on the CPU at their
smallest sizes, each in a subprocess: the printed checks of their
references (``examples/*.py``) — quickstart's serial against pipelined
``bit-identical to serial: True`` —, the LM example served from the
train example's checkpoint, and the refusal without a card."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# one torch thread a subprocess: the suite runs beside other workers
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
LM_SIZE = ("--d-model", "64", "--layers", "2", "--vocab", "512")


def _run(script, *argv, timeout=600):
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *argv], cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_pipelined_is_bit_identical_to_serial():
    out = _run("quickstart_torch.py", "--device", "cpu", "--vertices",
               "2000", "--edges", "20000", "--tile-size", "4096",
               "--supersteps", "10")
    assert "on cpu" in out
    assert re.search(r"2\. SPE .*\n   \d+ tiles of <= \d+ edges", out)
    assert re.search(r"converged=(True|False) in \d+ supersteps", out)
    assert re.search(r"top-5 vertices by rank: \[\(\d+, ", out)
    assert re.search(r"cache hit ratio [\d.]+ \| broadcast mode density", out)
    assert "bit-identical to serial: True" in out


def test_graph_analytics_runs_sssp_wcc_and_the_baselines():
    from repro_torch import compat
    from repro_torch.core.baselines import ENGINES

    out = _run("graph_analytics_torch.py", "--device", "cpu", "--vertices",
               "2000", "--edges", "20000", "--baseline-supersteps", "10")
    assert re.search(r"cache mode selected: [1-4] ", out)
    assert ("run on stdlib zlib" in out) == (not compat.HAVE_ZSTD)
    reached = int(re.search(r"SSSP: \d+ supersteps .*, ([\d,]+) reachable",
                            out).group(1).replace(",", ""))
    assert 0 < reached <= 2000
    assert re.search(r"WCC: \d+ supersteps, [\d,]+ components", out)
    rows = [line.split()[0] for line in out.splitlines()[-len(ENGINES) - 1:]]
    assert rows == ["graphh", *ENGINES]


def test_train_then_serve_from_its_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    out = _run("train_lm_torch.py", "--device", "cpu", "--steps", "6",
               "--batch", "4", "--seq", "32", "--ckpt-dir", ck, *LM_SIZE)
    m = re.search(r"final loss ([\d.]+) \(start ([\d.]+)\)", out)
    assert m and 0 < float(m.group(1)) < float(m.group(2))
    assert os.listdir(ck)
    out = _run("serve_lm_torch.py", "--device", "cpu", "--requests", "6",
               "--ckpt-dir", ck, *LM_SIZE)
    assert f"loaded params from {ck}" in out
    assert re.search(r"6 completions, 144 tokens in", out)


@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "graph_analytics_torch.py",
                                    "train_lm_torch.py",
                                    "serve_lm_torch.py"])
def test_examples_refuse_without_a_card(script):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                          cwd=ROOT, env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "pass --device cpu" in proc.stderr
