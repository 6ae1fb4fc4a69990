"""The port's one numerics setting, ``layers.exact_matmuls``: TF32 off,
bfloat16 partial sums in float32 (no reduced-precision reduction) and
float32 matmuls at "highest", as the reference's XLA dots compute; both
LM CLIs reach it before they build anything.  ``models/numerics.py``,
the rules the bfloat16 tests and the smoke hold runs to: the bfloat16
ulp at row scales 0.6, 4 and 2^-10 against the next bfloat16 value, the
per-row logit bound there, and the router's near-tie flips."""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import numerics


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


SCALES = {0.6: 2.0 ** -8, 4.0: 2.0 ** -5, 2.0 ** -10: 2.0 ** -17}


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_bf16_ulp_is_the_next_bfloat16_value(scale):
    """bf16_ulp at a row scale is the distance from its bfloat16 value to
    the next one up (8 significant bits), for either sign."""
    b = torch.tensor([scale], dtype=torch.bfloat16)
    up = (b.view(torch.int16) + 1).view(torch.bfloat16)
    step = float(up.float() - b.float())
    assert step == SCALES[scale]
    assert float(numerics.bf16_ulp(scale)) == step
    assert float(numerics.bf16_ulp(-scale)) == step
    assert float(numerics.bf16_ulp(np.float32(scale))) == step


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_bf16_logits_err_per_row_bound(scale):
    """A row whose largest |logit| is ``scale`` is held within the larger
    of LOGITS_ATOL and LOGITS_ULPS ulps of it (3e-2 at 0.6 and 2^-10,
    0.125 at 4): an error at the bound is 1.0 of it, in ulps the error
    over the ulp; a second row at another scale keeps its own bound, and
    a row left out by ``keep`` is not compared."""
    ulp = SCALES[scale]
    tol = max(numerics.LOGITS_ATOL, numerics.LOGITS_ULPS * ulp)
    assert tol == {0.6: 3e-2, 4.0: 0.125, 2.0 ** -10: 3e-2}[scale]
    want = torch.tensor([[scale, -scale / 2, 0.0, 7.0],
                         [0.5, 0.25, 0.125, 9.0]])
    got = want.clone()
    got[0, 2] += tol                      # at the bound, a logit near 0
    got[1, 0] += 0.5 * numerics.LOGITS_ATOL   # half its bound (3e-2)
    err, ulps, over = numerics.bf16_logits_err(got, want, vocab=3)
    assert err == pytest.approx(tol, rel=1e-6)
    assert ulps == pytest.approx(tol / ulp, rel=1e-6)
    assert over == pytest.approx(1.0, rel=1e-6)
    rows = numerics.logit_errors(got, want, 3)[2]
    assert float(rows[1]) == pytest.approx(0.5, rel=1e-5)
    got[0, 2] += tol                      # twice the bound, left out
    assert numerics.bf16_logits_err(got, want, 3)[2] == \
        pytest.approx(2.0, rel=1e-6)
    assert numerics.bf16_logits_err(got, want, 3, keep=[False, True])[2] \
        == float(rows[1])


def test_router_flips_and_the_positions_they_move():
    """Top-2 of 4 experts over two layers: a token whose 2nd and 3rd
    logits lie 1 ulp of its row's largest apart and swap is a near-tie
    flip; one 3 ulps apart is not; ties go to the lower expert id in
    both runs.  A flip before the last layer moves the later positions
    of its sequence, one at the last layer its own position only, and
    tokens routed otherwise after the first flip move too."""
    u = 2.0 ** -7                            # the ulp at 1.0
    want0 = torch.tensor([[1.0, 0.5, 0.5 - u, 0.0],    # 1 ulp apart
                          [1.0, 0.5, 0.5 - 3 * u, 0.0],
                          [1.0, 0.5, 0.5, 0.0],        # a tie: ids 0, 1
                          [0.9, 0.1, 0.0, 0.2]])
    got0 = want0.clone()
    got0[0, 2] += 2 * u                     # token 0 takes expert 2
    f = numerics.router_flips([want0, want0], [got0, want0], k=2)
    assert (f["layer"], f["tokens"], f["near_ties"], f["later"]) == \
        (0, [0], True, {})
    assert f["gaps"] == [pytest.approx(1.0)]
    got1 = want0.clone()
    got1[1, 2] += 4 * u                     # token 1: 3 ulps apart
    far = numerics.router_flips([want0, want0], [got1, got0], k=2)
    assert (far["layer"], far["tokens"], far["near_ties"],
            far["later"]) == (0, [1], False, {1: [0]})
    assert numerics.router_flips([want0], [want0.flip(0).flip(0)],
                                 k=2)["layer"] is None

    # tokens t = 2·row + position of a batch of 2 rows x 2 positions
    tr = numerics.FlipTracker(k=2)
    tr.add([want0, want0], [got0, want0], rows=[0, 0, 1, 1],
           positions=[0, 1, 0, 1])
    assert [tr.moved(b, s) for b in (0, 1) for s in (0, 1, 5)] == \
        [True, True, True, False, False, False]
    tr.add([want0, want0], [want0, got1], rows=[0, 0, 1, 1],
           positions=[2, 3, 2, 3])        # last layer, row 0 position 3
    assert tr.flipped() == 2 and tr.tokens == 8
    assert tr.moved(0, 3) and not tr.moved(1, 3) and not tr.moved(1, 2)
    with pytest.raises(AssertionError, match="near tie"):
        tr.check("four tokens")
