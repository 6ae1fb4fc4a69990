"""The port's language-model serving (``repro_torch.serve.engine``,
``serve.serve_step``, ``launch.serve``) on the CPU, against the JAX
package's engine and CLI.

Greedy tokens are compared for equality.  That is a fair demand only
where no step's choice is closer than the two packages' logit difference:
float32 logits agree within ``F32_ATOL = 1e-5`` (tests/test_torch_models.py),
so every sampled step's gap between its two largest logits is asserted
to exceed ``2 · F32_ATOL`` first.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import engine as teng
from repro_torch.serve.serve_step import build_serve_fns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5
RUN = RunConfig(remat="none", q_chunk=16, kv_chunk=16,
                compute_dtype="float32")
SUMMARY = re.compile(r"^(\d+) completions, (\d+) tokens in [\d.]+s "
                     r"\([\d.]+ tok/s, (\d+) decode steps, slots=(\d+)\)$")


def _requests(cls, cfg, n=5, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 10))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def _ref_params(arch="qwen3-1.7b", key=0):
    import jax
    from repro.configs import registry as jreg
    from repro.models.model_zoo import build_model as jbuild

    return jbuild(jreg.get_config(arch, reduced=True), RUN).init(
        jax.random.key(key))


def _port_model(arch="qwen3-1.7b", seed=0):
    cfg = treg.get_config(arch, reduced=True)
    return cfg, tzoo.build_model(cfg, RUN).init(seed)


def test_serve_engine_continuous_batching_consistency():
    """Counterpart of tests/test_runtime.py: 5 requests through 2 slots
    equal each request served alone in a 1-slot engine."""
    cfg, model = _port_model()
    reqs = _requests(teng.Request, cfg)
    eng = teng.ServeEngine(cfg, RUN, model, slots=2, max_len=48,
                           device="cpu")
    outs = {o.rid: o.tokens for o in eng.run_requests(reqs)}
    assert len(outs) == 5
    for rid in (0, 3):
        single = teng.ServeEngine(cfg, RUN, model, slots=1, max_len=48,
                                  device="cpu")
        ref = single.run_requests([teng.Request(
            rid=rid, prompt=reqs[rid].prompt, max_new_tokens=6)])
        assert outs[rid] == ref[0].tokens, rid


def test_serve_engine_sample_reseeds_per_step():
    """Counterpart of tests/test_serve_graph.py: draws from (rid, step) —
    steps differ, reruns repeat — greedy ignores the generator, and the
    draws equal the reference engine's on the same logits wherever the
    reference draws at all."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine

    eng = teng.ServeEngine.__new__(teng.ServeEngine)
    req = teng.Request(rid=5, prompt=np.zeros(1, np.int32), temperature=1.0)
    logits = np.zeros(64, np.float32)
    draws = [eng._sample(logits, req, step=s) for s in range(12)]
    assert len(set(draws)) > 1, "every decode step drew the same token"
    assert draws == [eng._sample(logits, req, step=s) for s in range(12)]
    g = teng.Request(rid=5, prompt=np.zeros(1, np.int32), temperature=0.0)
    peaked = np.zeros(64, np.float32)
    peaked[17] = 9.0
    assert eng._sample(peaked, g, step=3) == 17
    assert eng._sample(torch.from_numpy(peaked), g, step=3) == 17
    jeng = JEngine.__new__(JEngine)
    jreq = JRequest(rid=5, prompt=np.zeros(1, np.int32), temperature=1.0)
    assert draws == [jeng._sample(logits, jreq, step=s) for s in range(12)]
    ramp = np.linspace(-2, 2, 64).astype(np.float32)
    for t in (0.5, 1.0):
        req.temperature = jreq.temperature = t
        assert [eng._sample(ramp, req, step=s) for s in range(8)] == \
            [jeng._sample(ramp, jreq, step=s) for s in range(8)]
    # the reference divides by the float32 sum of p, which numpy's choice
    # refuses here (ROADMAP.md C); the port divides by the float64 sum
    req.temperature = jreq.temperature = 2.0
    with pytest.raises(ValueError, match="do not sum to 1"):
        jeng._sample(ramp, jreq, step=0)
    assert len({eng._sample(ramp, req, step=s) for s in range(8)}) > 1


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b"])
def test_engine_matches_reference_engine(arch):
    """The reference's ServeEngine and the port's on the same parameters
    and requests (7 requests, 3 slots, refills): equal greedy tokens for
    every request and equal stats, every sampled step's top-2 gap above
    2 · F32_ATOL."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine
    from repro.configs import registry as jreg

    params = _ref_params(arch, key=3)
    jcfg = jreg.get_config(arch, reduced=True)
    cfg = treg.get_config(arch, reduced=True)
    jeng = JEngine(jcfg, RUN, params, slots=3, max_len=40)
    want = {o.rid: o.tokens for o in jeng.run_requests(
        _requests(JRequest, jcfg, n=7, max_new=8, seed=1))}
    import jax
    eng = teng.ServeEngine(cfg, RUN, jax.tree.map(np.asarray, params),
                           slots=3, max_len=40, device="cpu")
    gaps = []
    sample = eng._sample

    def spy(logits, req, step):
        top = torch.topk(torch.as_tensor(logits).float(), 2).values
        gaps.append(float(top[0] - top[1]))
        return sample(logits, req, step)
    eng._sample = spy
    got = {o.rid: o.tokens for o in eng.run_requests(
        _requests(teng.Request, cfg, n=7, max_new=8, seed=1))}
    assert len(gaps) == sum(len(t) for t in got.values())
    assert min(gaps) > 2 * F32_ATOL, min(gaps)
    assert got == want
    assert eng.stats == jeng.stats


def test_engine_needs_a_card_unless_told_cpu():
    cfg, model = _port_model()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.ServeEngine(cfg, RUN, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from repro_torch.launch import serve as tserve
        tserve.main(["--reduced"])


def test_serve_fns_prefill_and_decode():
    """build_serve_fns without a mesh: prefill and decode on the builder's
    model loaded from a reference tree equal the model's own calls; a mesh
    raises naming A.13.2."""
    import jax

    cfg = treg.get_config("qwen3-1.7b", reduced=True)
    params = jax.tree.map(np.asarray, _ref_params(key=5))
    fns = build_serve_fns(cfg, RUN, max_len=16, batch=2,
                          cache_dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    cache, pre = fns["prefill"](params, fns["init_cache"](),
                                {"tokens": toks[:, :8]})
    cache, dec = fns["decode"](params, cache, toks[:, 8:], 8)
    model = tzoo.load_params(tzoo.build_model(cfg, RUN), params)
    with torch.no_grad():
        c2, pre2 = model.prefill(toks[:, :8], model.init_cache(
            2, 16, torch.float32))
        _, dec2 = model.decode_step(toks[:, 8:], c2, 8)
    assert torch.equal(pre, pre2) and torch.equal(dec, dec2)
    assert fns["shardings"] is None and fns["rules"] is None
    with pytest.raises(NotImplementedError, match="A.13.2"):
        build_serve_fns(cfg, RUN, mesh=object(), device="cpu")


def test_cli_prints_the_reference_summary(capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu`` prints
    the reference CLI's summary line, with its completions, tokens, decode
    steps and slots, and its first four requests."""
    from repro.launch import serve as jserve

    jserve.main(["--reduced", "--requests", "6", "--max-new", "5"])
    want = SUMMARY.match(capsys.readouterr().out.splitlines()[0]).groups()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "6", "--max-new", "5"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    got = SUMMARY.match(lines[0])
    assert got is not None, lines[0]
    assert got.groups() == want == ("6", "30", "8", "4")
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        f"  req {i}" for i in range(4)]


def test_cli_serves_a_reference_checkpoint(tmp_path, capsys):
    """``--ckpt-dir``: a checkpoint the reference's CheckpointManager
    wrote ({"params": tree}) is restored by the port's and served; the
    tokens equal the reference CLI's on the same checkpoint."""
    from repro.launch import serve as jserve
    from repro.train.checkpoint import CheckpointManager as JManager

    JManager(str(tmp_path / "ck")).save(7, {"params": _ref_params(key=6)})
    argv = ["--reduced", "--requests", "5", "--max-new", "6",
            "--ckpt-dir", str(tmp_path / "ck")]
    want = {o.rid: o.tokens for o in jserve.main(argv)}
    from repro_torch.launch import serve as tserve

    got = {o.rid: o.tokens for o in tserve.main(argv + ["--device", "cpu"])}
    assert "loaded params from" in capsys.readouterr().out
    assert got == want
