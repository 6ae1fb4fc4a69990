"""The port's training substrate (``repro_torch.train``, ``launch/train.py``)
on the CPU: the counterparts of ``tests/test_train_ckpt.py`` with the
port's real step, its optimizer and data against the JAX package's, the
weight-decay defect of the reference, the train CLI, and a trained
checkpoint served.

Tolerances:

* ``lr_schedule``: equal to the reference's float32 values where the
  packages' float32 cosines agree, within ``lr · 2^-22`` elsewhere;
* ``clip_by_global_norm``, ``adamw_update``: rtol ``1e-6``, atol
  ``1e-7`` (measured up to one float32 ulp: the global norm sums its
  squares in another order); ``topk_compress``: sent and residual
  equal, density within rtol ``1e-6``;
* the reference test's own bounds where the port holds itself: microbatch
  2 against 1 within rtol ``2e-4``, atol ``2e-5``; resume, failure
  injection and ``donate=False``: bit for bit.

The checkpoint cases of ``tests/test_train_ckpt.py`` (roundtrip,
compressed, crash atomicity, unreadable LATEST) have their counterparts in
``tests/test_torch_checkpoint.py``.
"""
import dataclasses
import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig
from repro_torch.models import model_zoo as tzoo
from repro_torch.runtime.ft import (FailureInjector, FaultTolerantLoop,
                                    SimulatedFailure)
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = RunConfig(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                compute_dtype="float32")
CFG = treg.get_config("qwen3-1.7b", reduced=True)
OPT = topt.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7


def _batches(n, batch=4, seq=32, seed=0):
    src = tdata.SyntheticLM(CFG, batch, seq, seed=seed)
    return [src.batch_at(i) for i in range(n)]


def _build(run=RUN, opt_cfg=OPT, **kw):
    return tts.build_train_step(CFG, run, opt_cfg, device="cpu", **kw)


def _params(state):
    return tzoo.export_params(state["params"])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def assert_trees_equal(got, want):
    for (pa, a), (pb, b) in zip(_leaves(got), _leaves(want), strict=True):
        assert pa == pb and np.array_equal(a, b), pa


# ---------------------------------------------------------------------------
# counterparts of tests/test_train_ckpt.py
# ---------------------------------------------------------------------------

def test_adamw_quadratic_convergence():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params)
    cfg = topt.OptConfig(lr=0.3, warmup_steps=1, decay_steps=1000,
                         weight_decay=0.0, grad_clip=100.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_lr_schedule_shape():
    c = topt.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                       min_lr_ratio=0.1)
    lrs = [float(topt.lr_schedule(c, torch.tensor(s))) for s in
           [0, 5, 10, 50, 100, 200]]
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    assert lrs[5] == pytest.approx(0.1, abs=1e-6)


def test_loss_decreases():
    step, init, _ = _build()
    state = init(0)
    losses = []
    for b in _batches(20):
        state, stats = step(state, b)
        losses.append(float(stats["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_microbatch_equivalence():
    """microbatch=2 equals microbatch=1 up to numerics (same global batch,
    gradients averaged)."""
    s1, init1, _ = _build()
    s2, init2, _ = _build(dataclasses.replace(RUN, microbatch=2))
    st1, st2 = init1(0), init2(0)
    for b in _batches(3):
        st1, _ = s1(st1, b)
        st2, _ = s2(st2, b)
    for (p, a), (_, b_) in zip(_leaves(_params(st1)), _leaves(_params(st2))):
        np.testing.assert_allclose(a, b_, rtol=2e-4, atol=2e-5, err_msg=p)


@pytest.mark.parametrize("compression", ["bf16", "topk"])
def test_grad_compression_trains(compression):
    step, init, _ = _build(dataclasses.replace(RUN,
                                               grad_compression=compression))
    state = init(0)
    losses = []
    for b in _batches(15):
        state, stats = step(state, b)
        losses.append(float(stats["loss"]))
    if compression == "topk":
        assert float(stats["density"]) <= 0.05
        assert float(stats["wire_ratio"]) == pytest.approx(
            2 * float(stats["density"]))
    assert losses[-1] < losses[0]


def test_resume_equivalence(tmp_path):
    """5 steps + save + restore + 5 steps == 10 straight steps, bit for bit
    (deterministic data pipeline, deterministic step on the CPU)."""
    step, init, _ = _build()
    batches = _batches(10)
    state = init(0)
    for b in batches:
        state, _ = step(state, b)
    straight = tzoo.export_state(state)

    mgr = CheckpointManager(str(tmp_path))
    state = init(0)
    for b in batches[:5]:
        state, _ = step(state, b)
    mgr.save(5, tzoo.export_state(state))
    _, state2 = mgr.restore(5)
    for b in batches[5:]:
        state2, _ = step(state2, b)        # the restored tree loads first
    assert_trees_equal(tzoo.export_state(state2), straight)


def test_failure_injection_and_recovery(tmp_path):
    step, init, _ = _build()
    batches = _batches(8)
    mgr = CheckpointManager(str(tmp_path))
    ft = FaultTolerantLoop(mgr, save_every=2, on_preempt_save=False,
                           export=tzoo.export_state)
    inj = FailureInjector({5})

    def run_job():
        start, state = ft.resume_or_init(lambda: init(0))
        for s in range(start, 8):
            inj.check(s)
            state, _ = step(state, batches[s])
            ft.maybe_save(s + 1, state)
        return state, start

    with pytest.raises(SimulatedFailure):
        run_job()                      # dies at step 5 (after ckpt at 4)
    state, start = run_job()           # resumes from 4, finishes
    assert start == 4 and mgr.all_steps() == [4, 6, 8]

    ref = init(0)
    for b in batches:
        ref, _ = step(ref, b)
    assert_trees_equal(tzoo.export_state(state), tzoo.export_state(ref))
    assert inj.failures == 1


def test_prefetcher_deterministic():
    src = tdata.SyntheticLM(CFG, 2, 16, seed=3)
    pf = tdata.Prefetcher(src, start_step=4)
    s, b = pf.next()
    pf.close()
    assert s == 4
    np.testing.assert_array_equal(b["tokens"], src.batch_at(4)["tokens"])


def test_donate_false_keeps_the_input_state():
    step, init, _ = _build(donate=False)
    state = init(1)
    before = tzoo.export_state(state)
    new, _ = step(state, _batches(1)[0])
    assert new is not state
    assert_trees_equal(tzoo.export_state(state), before)
    assert int(new["step"]) == 1 and int(state["step"]) == 0


# ---------------------------------------------------------------------------
# the optimizer and the data against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(lr=3e-4, warmup_steps=10, decay_steps=200),
    dict(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1),
    dict(lr=1e-3, warmup_steps=2, decay_steps=100)],
    ids=["cli", "shape", "tests"])
def test_lr_schedule_matches_reference(cfg):
    """Steps 0-200 against the reference's function called op by op:
    equal as float32 wherever the two packages' float32 cosines of the
    decay phase agree (every warmup step among them), and within
    lr · 2^-22 where they do not (XLA's cos and torch's differ by an ulp
    at a few percent of the steps, a few ulps of lr where 1 + cos is
    small; the jitted reference differs from its own op-by-op values at
    more)."""
    from repro.train import optimizer as jopt

    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    steps = np.arange(201, dtype=np.int32)
    want = np.stack([np.asarray(jopt.lr_schedule(jc, jnp.int32(s)))
                     for s in steps])
    got = np.stack([topt.lr_schedule(tc, torch.tensor(s)).numpy()
                    for s in steps])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tc.lr * 2.0 ** -22)
    prog = np.clip((steps.astype(np.float32) - np.float32(tc.warmup_steps))
                   / np.float32(max(tc.decay_steps - tc.warmup_steps, 1)),
                   0, 1).astype(np.float32) * np.float32(np.pi)
    same_cos = (np.asarray(jnp.cos(jnp.asarray(prog)))
                == torch.cos(torch.from_numpy(prog)).numpy())
    assert same_cos.mean() > 0.9
    np.testing.assert_array_equal(got[same_cos], want[same_cos])


def _ref_tree(seed, scale=1.0):
    """A stacked tree of the reference's shape: two cycles' leaves
    (matrices and norm scales), a tail layer, embeddings, a final norm."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"cycles": {"0L": {"attn": {"wq": f(2, 8, 6), "q_ln": {
        "scale": f(2, 6)}}, "ln1": {"scale": f(2, 8)}}},
        "embed": {"tok": f(20, 8)}, "final_norm": {"scale": f(8)},
        "tail": {"0L": {"ln1": {"scale": f(8)}, "mlp": {"wi": f(8, 5)}}}}


def _port_tree(tree, stacked=False):
    """The same tree as the port's optimizer sees it: each ``cycles`` leaf
    a list of one tensor a cycle."""
    if isinstance(tree, dict):
        return {k: _port_tree(v, stacked or k == "cycles")
                for k, v in tree.items()}
    if stacked:
        return [torch.tensor(x) for x in tree]
    return torch.tensor(tree)


def _is_cycle_norm_scale(path):
    return "/cycles/" in path and path.endswith("/scale")


def test_clip_adamw_and_topk_match_reference():
    """The same stacked tree through the reference's functions and the
    port's: clip, three AdamW updates at weight_decay 0.1 (every leaf but
    the cycles' norm scales: ROADMAP.md C), two top-k compressions."""
    from repro.train import optimizer as jopt

    jp, tp = _ref_tree(0), _port_tree(_ref_tree(0))
    g = _ref_tree(1, scale=3.0)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = topt.clip_by_global_norm(_port_tree(g), 1.0)
    assert float(jn) > 1.0
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    for (p, a), (_, b) in zip(_leaves(tzoo._numpy(tc)), _leaves(
            jax.tree.map(np.asarray, jc)), strict=True):
        np.testing.assert_allclose(a, b, rtol=OPT_RTOL, atol=OPT_ATOL,
                                   err_msg=p)

    cfg = dict(lr=0.05, warmup_steps=2, decay_steps=10)
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts_ = jopt.adamw_init(jp), topt.adamw_init(tp)
    for k in range(3):
        g = _ref_tree(10 + k, scale=0.1)
        jp, js, jstats = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                           js, jopt.OptConfig(**cfg))
        tp, ts_, tstats = topt.adamw_update(tp, _port_tree(g), ts_,
                                            topt.OptConfig(**cfg))
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]),
                                       rtol=OPT_RTOL, err_msg=key)
    assert int(ts_["step"]) == int(js["step"]) == 3
    for name, got, want in (("p", tp, jp), ("m", ts_["m"], js["m"]),
                            ("v", ts_["v"], js["v"])):
        for (p, a), (_, b) in zip(_leaves(tzoo._numpy(got)), _leaves(
                jax.tree.map(np.asarray, want)), strict=True):
            if name == "p" and _is_cycle_norm_scale(p):
                continue
            np.testing.assert_allclose(a, b, rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=name + p)

    jef, tef = jopt.ef_init(jp), topt.ef_init(tp)
    for k in range(2):
        g = _ref_tree(20 + k)
        jg, jef, jst = jopt.topk_compress(jax.tree.map(jnp.asarray, g), jef,
                                          density=0.1)
        tg, tef, tst = topt.topk_compress(_port_tree(g), tef, density=0.1)
        assert_trees_equal(tzoo._numpy(tg), jax.tree.map(np.asarray, jg))
        assert_trees_equal(tzoo._numpy(tef["residual"]),
                           jax.tree.map(np.asarray, jef["residual"]))
        for key in ("density", "wire_ratio"):
            np.testing.assert_allclose(float(tst[key]), float(jst[key]),
                                       rtol=OPT_RTOL, err_msg=key)


def test_weight_decay_spares_every_norm_scale():
    """ROADMAP.md C: one AdamW update with zero gradients at lr 1 and
    weight_decay 0.1 on gemma2-2b reduced to 3 layers (one "LG" cycle and
    a tail layer).  The reference decays the cycle's norm scales (its
    stacked leaves have ndim 2) to 1 - 0.1 and leaves the tail's and the
    final norm's at 1; the port leaves every norm scale at 1 and decays
    the same matrices as the reference (within an ulp)."""
    import dataclasses

    from repro.configs import registry as jreg
    from repro.models.model_zoo import build_model as jbuild
    from repro.train import optimizer as jopt

    cfg = dataclasses.replace(treg.get_config("gemma2-2b", reduced=True),
                              num_layers=3)
    jcfg = dataclasses.replace(jreg.get_config("gemma2-2b", reduced=True),
                               num_layers=3)
    jp = jbuild(jcfg).init(jax.random.key(0))
    model = tzoo.load_params(tzoo.build_model(cfg), jax.tree.map(np.asarray,
                                                                 jp))
    opt_kw = dict(lr=1.0, warmup_steps=1, weight_decay=0.1)
    jp, _, _ = jax.jit(lambda p: jopt.adamw_update(
        p, jax.tree.map(jnp.zeros_like, p), jopt.adamw_init(p),
        jopt.OptConfig(**opt_kw)))(jp)
    tp = tzoo.param_tree(model)
    topt.adamw_update(tp, topt.member_map(torch.zeros_like, tp),
                      topt.adamw_init(tp), topt.OptConfig(**opt_kw))
    jp = jax.tree.map(np.asarray, jp)
    decayed = np.float32(1) - np.float32(1) * (np.float32(0.1) * np.float32(1))
    np.testing.assert_array_equal(jp["cycles"]["0L"]["ln1"]["scale"], decayed)
    np.testing.assert_array_equal(jp["cycles"]["1G"]["ln2"]["scale"], decayed)
    np.testing.assert_array_equal(jp["tail"]["0L"]["ln1"]["scale"], 1.0)
    np.testing.assert_array_equal(jp["final_norm"]["scale"], 1.0)
    norms = 0
    for (p, a), (_, b) in zip(_leaves(tzoo.export_params(model)),
                              _leaves(jp), strict=True):
        if p.endswith("/scale"):
            np.testing.assert_array_equal(a, 1.0, err_msg=p)
            norms += 1
        else:       # the jitted reference fuses p - lr·wd·p: an ulp apart
            np.testing.assert_allclose(a, b, rtol=2.0 ** -22, atol=0,
                                       err_msg=p)
    assert norms == 2 * 3 + 1


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-76b",
                                  "whisper-base"])
def test_synthetic_batches_match_reference(arch):
    from repro.configs import registry as jreg
    from repro.train import data as jdata

    for seed, step in ((0, 0), (0, 7), (3, 2)):
        want = jdata.SyntheticLM(jreg.get_config(arch, reduced=True), 3, 24,
                                 seed=seed).batch_at(step)
        got = tdata.SyntheticLM(treg.get_config(arch, reduced=True), 3, 24,
                                seed=seed).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bin_corpus_matches_reference(tmp_path):
    from repro.configs import registry as jreg
    from repro.train import data as jdata

    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    want = jdata.BinCorpus(path, jreg.get_config("qwen3-1.7b", reduced=True),
                           4, 32, seed=2).batch_at(5)
    got = tdata.BinCorpus(path, CFG, 4, 32, seed=2).batch_at(5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# build_train_step and the CLI
# ---------------------------------------------------------------------------

def test_build_train_step_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.build_train_step(CFG, RUN)
    from repro_torch.launch import train as ttrain

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced"])


STEP_LINE = re.compile(r"step +(\d+) loss ([\d.]+) lr \S+ gnorm [\d.]+ \| "
                       r"[\d,]+ tok/s$")
FINAL_LINE = re.compile(r"final loss ([\d.]+) \(start ([\d.]+)\)$")
INIT_LINE = re.compile(r"init in [\d.]+s; params = ([\d,]+)$")


def _kinds(lines):
    out = []
    for ln in lines:
        for name, rx in (("step", STEP_LINE), ("final", FINAL_LINE),
                         ("init", INIT_LINE)):
            if rx.match(ln):
                out.append(name)
                break
        else:
            out.append(ln)
    return out


def _cli(argv, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *argv], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_cli_prints_the_reference_lines_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: the
    reference CLI's lines in its order, with its parameter count and step
    numbers (the losses differ: ``LM.init`` draws other values than the
    reference's), the loss falls; rerun on the same --ckpt-dir with more
    steps, it resumes."""
    from repro.launch import train as jtrain

    argv = ["--reduced", "--steps", "12", "--batch", "4", "--seq", "32",
            "--log-every", "4"]
    jtrain.main(argv)
    want = capsys.readouterr().out.splitlines()
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "6"]
    got = _cli(argv + ck, tmp_path)
    assert [k for k in _kinds(got) if not k.startswith("[ckpt]")] \
        == _kinds(want) == ["init", "step", "step", "step", "final"]
    assert [ln for ln in got if ln.startswith("[ckpt]")] == [
        "[ckpt] step 6", "[ckpt] step 12"]
    assert INIT_LINE.match(got[0]).group(1) \
        == INIT_LINE.match(want[0]).group(1) == "106,880"
    assert [STEP_LINE.match(ln).group(1) for ln in got if STEP_LINE.match(
        ln)] == [STEP_LINE.match(ln).group(1) for ln in want
                 if STEP_LINE.match(ln)] == ["4", "8", "12"]
    last, first = map(float, FINAL_LINE.match(got[-1]).groups())
    assert last < first

    again = _cli(["--reduced", "--steps", "16", "--batch", "4", "--seq",
                  "32", "--log-every", "4"] + ck, tmp_path)
    assert again[0] == "resumed from checkpoint at step 12"
    assert [STEP_LINE.match(ln).group(1) for ln in again
            if STEP_LINE.match(ln)] == ["16"]
    assert "[ckpt] step 16" not in again     # not due; the final save is
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 16


def test_cli_train_then_serve(tmp_path):
    """Dense counterpart of tests/test_system.py::test_lm_train_then_serve
    (granite-moe's is in tests/test_torch_families_lm.py): train qwen3-1.7b
    reduced with checkpoints, then serve the trained checkpoint through
    --ckpt-dir."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    ck = str(tmp_path / "ck")
    losses = ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                          "12", "--batch", "4", "--seq", "32", "--ckpt-dir",
                          ck, "--ckpt-every", "6", "--log-every", "6",
                          "--device", "cpu"])
    assert losses[-1] < losses[0]
    outs = tserve.main(["--arch", "qwen3-1.7b", "--reduced", "--requests",
                        "4", "--slots", "2", "--max-new", "4", "--max-len",
                        "48", "--prompt-len", "6", "--ckpt-dir", ck,
                        "--device", "cpu"])
    assert len(outs) == 4
    assert all(len(o.tokens) == 4 for o in outs)


def test_reference_labels_a_preempted_state_as_the_last_step(tmp_path,
                                                              monkeypatch):
    """ROADMAP.md C: after a preemption at step 3 of 8, the reference CLI
    saves the state again as step 8, so a rerun skips steps 4-8; the port
    keeps step 3 as its latest checkpoint."""
    from repro.launch import train as jtrain
    from repro.runtime import ft as jft
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime import ft as tft

    def stop_at(n):
        calls = []

        def should_stop(self):
            calls.append(1)
            return len(calls) == n
        return should_stop

    argv = ["--reduced", "--steps", "8", "--batch", "2", "--seq", "16",
            "--log-every", "4", "--ckpt-every", "100"]
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    monkeypatch.setattr(jft.FaultTolerantLoop, "should_stop", stop_at(3))
    try:
        jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    finally:            # the reference CLI leaves its handlers installed
        for s, h in handlers.items():
            signal.signal(s, h)
    monkeypatch.setattr(tft.FaultTolerantLoop, "should_stop", stop_at(3))
    ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device",
                        "cpu"])
    ref = CheckpointManager(str(tmp_path / "ref"))
    assert ref.all_steps() == [3, 8]
    assert int(ref.restore()[1]["step"]) == 3
    port = CheckpointManager(str(tmp_path / "port"))
    assert port.all_steps() == [3]
    assert int(port.restore()[1]["step"]) == 3
