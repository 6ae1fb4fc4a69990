#!/usr/bin/env python3
"""The port's four examples at their defaults on this machine's card.

    python3 chip_probe_examples.py

Runs ``examples/quickstart_torch.py``, ``graph_analytics_torch.py``,
``train_lm_torch.py`` (then again with ``--steps 320``, which resumes
from its checkpoint) and ``serve_lm_torch.py`` (which serves that
checkpoint), each in a process of its own with ``--device cuda``, the
train and serve pair on a checkpoint directory of their own; records
each one's wall time, exit code and printed lines, and checks the
printed checks: quickstart's ``bit-identical to serial: True``, the
SSSP and WCC lines, the trained loss below its start, the resume, the
served checkpoint.  Writes ``chiprun_out/chip_probe_examples.json`` and
prints a summary; exits 1 when an example fails or a check does not
hold.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def run(script, *argv):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *argv],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=1800)
    lines = [ln for ln in proc.stdout.splitlines()
             if not ln.startswith("[")]          # the CLIs' result lists
    return dict(script=script, argv=list(argv), rc=proc.returncode,
                wall_s=time.perf_counter() - t0, out=lines,
                err=proc.stderr[-2000:] if proc.returncode else "")


def main():
    ck = os.path.join(tempfile.mkdtemp(prefix="examples_"), "ck")
    runs = [run("quickstart_torch.py"), run("graph_analytics_torch.py"),
            run("train_lm_torch.py", "--ckpt-dir", ck),
            run("train_lm_torch.py", "--ckpt-dir", ck, "--steps", "320"),
            run("serve_lm_torch.py", "--ckpt-dir", ck)]
    text = ["\n".join(r["out"]) for r in runs]
    loss = re.search(r"final loss ([\d.]+) \(start ([\d.]+)\)", text[2])
    checks = {
        "quickstart bit-identical": "bit-identical to serial: True" in text[0],
        "sssp and wcc": bool(re.search(r"SSSP: \d+ supersteps", text[1])
                             and re.search(r"WCC: \d+ supersteps", text[1])),
        "loss falls": bool(loss) and float(loss.group(1)) < float(
            loss.group(2)),
        "train resumes": "resumed from checkpoint at step 300" in text[3],
        "serves the checkpoint": f"loaded params from {ck}" in text[4],
    }
    ok = all(r["rc"] == 0 for r in runs) and all(checks.values())
    out = dict(ok=ok, checks=checks, runs=runs)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_probe_examples.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    for r in runs:
        print(f"== {r['script']} {' '.join(r['argv'])}: rc {r['rc']}, "
              f"{r['wall_s']:.1f} s")
        print("\n".join(r["out"][-25:]))
        if r["err"]:
            print(r["err"])
    print(json.dumps(dict(ok=ok, checks=checks)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
