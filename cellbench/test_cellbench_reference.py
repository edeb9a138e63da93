"""The plain reference against the program on the CPU, on tiny float32
configurations of both families: the weights' names and shapes, the
training logits, a served request's logits at prefill and through the
cache, and three training steps' losses, gradients and changes. The tiny
MLA configurations' drawn weights run through the port's training
forward and its engine."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cellbench import testing
from cellbench.harness import compare, manifest, weights
from cellbench.harness.program import model_config
from cellbench.kinds import train
from cellbench.reference import decoder

CONFIGS = Path(__file__).parent / "configs"


@pytest.mark.parametrize("cfg", [
    json.loads((CONFIGS / f"{name}.json").read_text())
    for name in ("internlm2-1.8b", "qwen2-moe-a2.7b")]
    + [testing.MLA, testing.MLA_Q], ids=lambda c: c["name"])
def test_drawn_leaves_are_the_programs(cfg):
    from repro_torch.models.params import model_defs
    shapes = {}
    for kind, shape, leaves, _, _ in weights.layout(cfg["model"]):
        for leaf in leaves:
            shapes[leaf] = shape[1:] if weights.stacked(kind) else shape
    assert shapes == {k: d.shape for k, d in
                      model_defs(model_config(cfg)).items()}


@pytest.mark.parametrize("cfg", [testing.DENSE, testing.MOE],
                         ids=lambda c: c["name"])
def test_training_logits(cfg):
    from repro_torch.models.transformer import Transformer, train_logits
    m = cfg["model"]
    p = weights.draw(m, 3, "cpu", serving=False)
    model = Transformer(model_config(cfg), p, device="cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = train_logits(model, {"tokens": tokens}, remat="none")[0]
        for r in range(2):
            ref = decoder.logits(m, p, tokens[r])
            assert torch.allclose(got[r], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cfg", [testing.DENSE, testing.MOE],
                         ids=lambda c: c["name"])
def test_served_logits_at_prefill_and_through_the_cache(cfg):
    """The engine's logits rows, as its token pick gets them, against the
    reference's full forward over the prompt and the served tokens. The
    engine's cache holds K and V in bf16, so a decode row is within a few
    bf16 roundings of the values it attends to: 1% of the row's largest
    logit."""
    from repro_torch.serve.engine import ServeEngine
    m = cfg["model"]
    p = weights.draw(m, 4, "cpu", serving=True)
    engine = ServeEngine(model_config(cfg), p, max_batch=2, max_seq=48,
                         device="cpu")
    rows = []
    pick = engine._pick
    engine._pick = lambda logits, *a: rows.append(logits.copy()) or pick(
        logits, *a)
    prompt = torch.randint(0, m["vocab_size"], (17,),
                           generator=torch.Generator().manual_seed(2)).tolist()
    req = engine.add_request(prompt, max_new=6)
    while engine.active():
        engine.step()
    seq = torch.as_tensor(prompt + req.tokens[:-1])
    ref = decoder.logits(m, p, seq, range(16, 22))
    got = torch.as_tensor(np.stack(rows))
    assert torch.allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)
    assert (got - ref).abs().max() <= 0.01 * ref.abs().max()
    assert max(compare.token_gaps(ref, req.tokens)) < 1e-2


def test_three_training_steps(tmp_path):
    """In float32 the program and the reference differ only in the order
    of their sums: losses, every leaf's first gradient and change agree to
    1e-5 of the median leaf."""
    cell = manifest.load_cell(testing.make_root(tmp_path), "tiny-dense.train")
    prog = train.Session(cell, 2 ** 31 + 9, "cpu", False).checked()
    ref = train.reference_readings(cell, 2 ** 31 + 9, "cpu")
    got = train.numbers(prog, ref)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-5
    assert len(compare.moved_leaves(ref["first"])) == len(ref["first"])


@pytest.mark.parametrize("cfg", [testing.MLA, testing.MLA_Q],
                         ids=lambda c: c["name"])
def test_the_port_runs_drawn_mla_weights(cfg):
    """A dense leading layer, then MLA with experts: the port's training
    forward and its engine's prefill and absorbed decode run on the drawn
    weights, to finite logits of the vocabulary's width."""
    from repro_torch.models.transformer import Transformer, train_logits
    from repro_torch.serve.engine import ServeEngine
    m = cfg["model"]
    p = weights.draw(m, 5, "cpu", serving=False)
    model = Transformer(model_config(cfg), p, device="cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 20),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = train_logits(model, {"tokens": tokens}, remat="none")[0]
    assert got.shape == (2, 20, m["vocab_size"]) and got.isfinite().all()
    engine = ServeEngine(model_config(cfg),
                         weights.draw(m, 5, "cpu", serving=True),
                         max_batch=2, max_seq=32, device="cpu")
    rows = []
    pick = engine._pick
    engine._pick = lambda logits, *a: rows.append(logits.copy()) or pick(
        logits, *a)
    req = engine.add_request(tokens[0, :11].tolist(), max_new=4)
    while engine.active():
        engine.step()
    assert len(req.tokens) == 4 and len(rows) == 4
    assert all(r.shape == (m["vocab_size"],) and np.isfinite(r).all()
               for r in rows)
