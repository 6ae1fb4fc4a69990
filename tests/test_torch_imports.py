"""The port imports neither ``jax`` nor any module of the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (pytest's own has jax loaded already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "print(' '.join(names))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, names = proc.stdout.splitlines()[0], proc.stdout.splitlines()[1]
    assert int(count.split()[0]) >= 35
    for name in ("repro_torch.kernels.compact", "repro_torch.core.distributed",
                 "repro_torch.core.engine", "repro_torch.kernels.ops",
                 "repro_torch.core.vstate", "repro_torch.launch.cluster",
                 "repro_torch.core.transport", "repro_torch.core.comm",
                 "repro_torch.runtime.scheduler", "repro_torch.runtime.faults",
                 "repro_torch.runtime.ft", "repro_torch.runtime.elastic",
                 "repro_torch.train.checkpoint",
                 "repro_torch.core.checkpoint",
                 "repro_torch.serve.graph_service", "repro_torch.serve.http",
                 "repro_torch.roofline.hw", "repro_torch.roofline.kernel_tune",
                 "repro_torch.core.baselines", "repro_torch.kernels.blocks",
                 *LM_MODULES):
        assert name in names.split()


# the A.13.1 modules (the configs, the dense decoders and their serving),
# the training of A.13.2, the families of A.13.3, the mesh of A.13.2b and
# the dry run, roofline and report tools of A.13.4
LM_MODULES = (
    "repro_torch.configs.base", "repro_torch.configs.registry",
    *(f"repro_torch.configs.{m}" for m in (
        "dbrx_132b", "deepseek_7b", "gemma2_2b", "granite_moe_1b",
        "internvl2_76b", "qwen3_14b", "qwen3_1_7b", "recurrentgemma_9b",
        "rwkv6_1_6b", "whisper_base")),
    "repro_torch.models.layers", "repro_torch.models.transformer",
    "repro_torch.models.model_zoo", "repro_torch.serve.engine",
    "repro_torch.serve.serve_step", "repro_torch.launch.serve",
    # A.13.2's single-device half: training
    "repro_torch.train.data", "repro_torch.train.optimizer",
    "repro_torch.train.train_step", "repro_torch.launch.train",
    # A.13.3: the other families
    "repro_torch.models.moe", "repro_torch.models.rglru",
    "repro_torch.models.rwkv6", "repro_torch.models.encdec",
    # A.13.2b: the mesh
    "repro_torch.models.sharding", "repro_torch.launch.mesh",
    # A.13.4: the dry run, roofline and report tools
    "repro_torch.launch.dryrun", "repro_torch.launch.perf",
    "repro_torch.launch.report", "repro_torch.launch.compare",
    "repro_torch.roofline.analysis", "repro_torch.roofline.hlo_cost")


def test_config_modules_mirror_the_reference():
    """Every reference config module has its port counterpart, and the
    registry names only port modules."""
    from repro_torch.configs import registry

    ref = sorted(p.stem for p in (ROOT / "src" / "repro" / "configs")
                 .glob("*.py") if p.stem != "__init__")
    port = sorted(p.stem for p in (PORT / "configs").glob("*.py")
                  if p.stem != "__init__")
    assert port == ref
    assert all(m.startswith("repro_torch.configs.")
               for m in registry.ARCH_MODULES.values())


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "chip_probe_c1.py",
                            ROOT / "chip_probe_mesh.py",
                            ROOT / "chip_probe_dryrun.py",
                            ROOT / "chip_probe_examples.py",
                            ROOT / "chip_probe_four.py"]
                         + sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_reference_import(path):
    bad = [line for line in path.read_text().splitlines()
           if FORBIDDEN.match(line)]
    assert not bad, bad


# the A.10 flags with the reference's defaults (repro/launch/graph.py and
# repro/launch/cluster.py)
A10_DEFAULTS = dict(checkpoint_dir=None, checkpoint_every=0, resume=False,
                    preemptible=False, on_failure="fail", max_restarts=2,
                    inject=None)
A10_ARGV = (["--checkpoint-dir", "ck", "--checkpoint-every", "3", "--resume",
             "--preemptible", "--on-failure", "shrink", "--max-restarts",
             "4", "--inject", "site=superstep,superstep=2", "--inject",
             "site=barrier,rank=1,kind=kill"],
            dict(checkpoint_dir="ck", checkpoint_every=3, resume=True,
                 preemptible=True, on_failure="shrink", max_restarts=4,
                 inject=["site=superstep,superstep=2",
                         "site=barrier,rank=1,kind=kill"]))


@pytest.mark.parametrize("cli", ["graph", "cluster"])
def test_cli_takes_the_checkpoint_and_fault_flags(cli):
    """Both CLIs of the port take every A.10 flag with the reference's
    default; a ``--cluster`` run passes them on to the cluster CLI."""
    from repro_torch.launch import cluster as tcluster
    from repro_torch.launch import graph as tgraph

    parse = tgraph.parse_args if cli == "graph" else tcluster.parse_args
    args = parse([])
    assert {k: getattr(args, k) for k in A10_DEFAULTS} == A10_DEFAULTS
    argv, want = A10_ARGV
    args = parse(argv)
    assert {k: getattr(args, k) for k in want} == want
    if cli == "graph":
        passed = tcluster.parse_args(tgraph._cluster_argv(
            tgraph.parse_args(["--cluster"] + argv)))
        assert {k: getattr(passed, k) for k in want} == want


# the A.11 serve flags with the reference's defaults (repro/launch/graph.py)
SERVE_DEFAULTS = dict(q_slots=8, min_fill=1, max_wait_ms=50.0,
                      deadline_ms=None, serve_requests=32, serve_qps=0.0,
                      serve_apps="ppr,msbfs", drain_mode="finish",
                      host="127.0.0.1", port=8080, tenants=None,
                      result_cache=0, drain_linger_ms=500.0)


@pytest.mark.parametrize("flag", ["--serve", "--serve-http"])
def test_cli_serve_flags_parse_to_reference_defaults(flag):
    """``--serve`` and ``--serve-http`` parse, with every serve flag at
    the reference's default, and each flag takes a value."""
    from repro_torch.launch import graph as tgraph

    args = tgraph.parse_args([flag, "--checkpoint-dir", "ck"])
    assert (args.serve, args.serve_http) == (flag == "--serve",
                                             flag == "--serve-http")
    assert {k: getattr(args, k) for k in SERVE_DEFAULTS} == SERVE_DEFAULTS
    args = tgraph.parse_args([
        flag, "--q-slots", "4", "--min-fill", "2", "--max-wait-ms", "10",
        "--deadline-ms", "250", "--serve-requests", "0", "--serve-qps", "5",
        "--serve-apps", "msbfs,landmarks", "--drain-mode", "checkpoint",
        "--host", "0.0.0.0", "--port", "0", "--tenants", "a:3,b:1",
        "--result-cache", "64", "--drain-linger-ms", "0"])
    assert {k: getattr(args, k) for k in SERVE_DEFAULTS} == dict(
        q_slots=4, min_fill=2, max_wait_ms=10.0, deadline_ms=250.0,
        serve_requests=0, serve_qps=5.0, serve_apps="msbfs,landmarks",
        drain_mode="checkpoint", host="0.0.0.0", port=0, tenants="a:3,b:1",
        result_cache=64, drain_linger_ms=0.0)


@pytest.mark.parametrize("name,port_name", [
    ("fused", "fused"), ("segment", "segment"), ("pallas_fused", "fused"),
    ("pallas_onehot", "segment"), ("jnp", "segment")])
def test_cli_takes_reference_seg_impl_names(name, port_name):
    """The reference's --seg-impl backends map onto the port's two."""
    from repro_torch.launch import graph as tgraph

    assert tgraph.parse_args(["--seg-impl", name]).seg_impl == port_name
    assert tgraph.parse_args([]).seg_impl == "fused"
