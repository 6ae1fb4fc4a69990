"""The port's one numerics setting, ``layers.exact_matmuls``: TF32 off,
bfloat16 partial sums in float32 (no reduced-precision reduction) and
float32 matmuls at "highest", as the reference's XLA dots compute; both
LM CLIs reach it before they build anything."""
import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers


@pytest.fixture
def saved_numerics():
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction,
             torch.get_float32_matmul_precision())
    yield
    (m.allow_tf32, torch.backends.cudnn.allow_tf32,
     m.allow_bf16_reduced_precision_reduction) = saved[:3]
    torch.set_float32_matmul_precision(saved[3])


def test_exact_matmuls_sets_the_reference_numerics(saved_numerics):
    m = torch.backends.cuda.matmul
    m.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    m.allow_bf16_reduced_precision_reduction = True
    torch.set_float32_matmul_precision("high")
    layers.exact_matmuls()
    assert m.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert m.allow_bf16_reduced_precision_reduction is False
    assert torch.get_float32_matmul_precision() == "highest"


class Reached(Exception):
    pass


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_main_reaches_exact_matmuls(monkeypatch, cli):
    """Each CLI's main calls the helper, before it builds a model (the spy
    stops it there: nothing is built or trained)."""
    built = []

    def spy():
        raise Reached

    monkeypatch.setattr(layers, "exact_matmuls", spy)
    mod = {"serve": tserve, "train": ttrain}[cli]
    monkeypatch.setattr(mod.registry, "get_config",
                        lambda *a, **k: built.append(a))
    with pytest.raises(Reached):
        mod.main(["--reduced", "--device", "cpu"])
    assert built == []
