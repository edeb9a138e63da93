"""DeepSeek-V2's path through the port against the plain reference
(``reference/deepseek_v2.py``) on the CPU, on a tiny float32 configuration
laid out as DeepSeek-V2-Lite is (a dense leading layer, then latent
attention with experts and two shared ones, no query compression) with
YaRN at an original context of 16 and a factor of 4, over 64 positions:
the training logits at every position, and a served request's logits at
prefill and through the latent cache in both decode forms. The port with
YaRN off fails the same tolerances. Then the configuration file against
its source and the port's layout, the two MLA span readers on hand-built
traces, and a traced run of a tiny cell of the kind."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cellbench import testing
from cellbench.harness import attribution, compare, manifest, weights
from cellbench.harness.program import model_config
from cellbench.harness.tracing import Trace
from cellbench.reference import deepseek_v2
from cellbench.test_cellbench_manifest import check_against_source

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "cellbench" / "configs"
                     / "deepseek-v2-lite.json").read_text())
YARN = dict(rope_scaling="yarn", rope_factor=4,
            rope_original_max_positions=16, yarn_beta_fast=32,
            yarn_beta_slow=1, yarn_mscale=1.0, yarn_mscale_all_dim=0.707)
TINY = {"name": "tiny-dsv2", "reference": "deepseek_v2",
        "model": dict(testing.MLA["model"], **YARN)}
# the same weights run by a port told nothing of YaRN
OFF = {"name": "tiny-dsv2-off", "reference": "deepseek_v2",
       "model": dict(testing.MLA["model"])}
SEQ = 64


def _tokens(n, seed):
    return torch.randint(0, TINY["model"]["vocab_size"], (n,),
                         generator=torch.Generator().manual_seed(seed))


def _train_logits(cfg, p, tokens):
    from repro_torch.models.transformer import Transformer, train_logits
    model = Transformer(model_config(cfg), p, device="cpu")
    with torch.no_grad():
        return train_logits(model, {"tokens": tokens}, remat="none")[0]


def test_training_logits_at_every_position():
    """float32 on both sides: they differ in the order of their sums."""
    m = TINY["model"]
    p = weights.draw(m, 7, "cpu", serving=False)
    tokens = torch.stack([_tokens(SEQ, 1), _tokens(SEQ, 2)])
    ref = torch.stack([deepseek_v2.logits(m, p, t) for t in tokens])
    close = dict(rtol=1e-4, atol=1e-5)
    assert torch.allclose(_train_logits(TINY, p, tokens), ref, **close)
    assert not torch.allclose(_train_logits(OFF, p, tokens), ref, **close)


def _served(cfg, p, prompt, max_new, absorbed):
    """The engine's logits rows, as its token pick gets them, and the
    served tokens."""
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serve.engine import ServeEngine
    engine = ServeEngine(model_config(cfg), p, max_batch=2, max_seq=SEQ,
                         device="cpu", flags=RunFlags(mla_absorbed=absorbed))
    rows, pick = [], engine._pick
    engine._pick = lambda logits, *a: rows.append(logits.copy()) or pick(
        logits, *a)
    req = engine.add_request(prompt, max_new=max_new)
    while engine.active():
        engine.step()
    return torch.as_tensor(np.stack(rows)), req.tokens


def _gap(cfg, p, absorbed):
    """The prefill row's and the decode rows' largest distance from the
    reference's full forward over the prompt and the served tokens, over
    the reference's largest logit."""
    m = TINY["model"]
    prompt = _tokens(40, 3).tolist()
    got, served = _served(cfg, p, prompt, 23, absorbed)
    seq = torch.as_tensor(prompt + served[:-1])
    ref = deepseek_v2.logits(m, p, seq, range(39, 39 + len(served)))
    top = ref.abs().max()
    return ((got[0] - ref[0]).abs().max() / top,
            (got[1:] - ref[1:]).abs().max() / top, ref, served)


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
def test_served_logits_through_the_latent_cache(absorbed):
    """A 40-token prompt, 23 tokens decoded to position 62: the prefill
    row is float32 throughout (1e-5 of the largest logit); a decode row
    reads the latent and the rope key back from the bf16 cache, within a
    few bf16 roundings of the values it attends to (1% of the largest
    logit). YaRN off reads beyond both."""
    p = weights.draw(TINY["model"], 8, "cpu", serving=True)
    first, rest, ref, served = _gap(TINY, p, absorbed)
    assert first < 1e-5 and rest < 0.01
    assert max(compare.token_gaps(ref, served)) < 1e-2
    first, rest, _, _ = _gap(OFF, p, absorbed)
    assert first > 1e-5 and rest > 0.01


def test_the_file_against_its_source():
    """The YaRN fields are the published ``rope_scaling``; the model is
    the one ``testing.DSV2_LITE`` lays out as the port's ``model_defs``,
    plus them, at 15.71e9 parameters and nothing cut."""
    from repro_torch.models.params import model_defs
    pub, m = CONFIG["published"], CONFIG["model"]
    rs = pub["rope_scaling"]
    assert rs["type"] == m["rope_scaling"] == "yarn"
    assert (m["rope_factor"], m["rope_original_max_positions"],
            m["yarn_beta_fast"], m["yarn_beta_slow"], m["yarn_mscale"],
            m["yarn_mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"],
        rs["mscale_all_dim"])
    assert {k: v for k, v in m.items() if k not in YARN} == \
        testing.DSV2_LITE["model"]
    assert set(m) - set(testing.DSV2_LITE["model"]) == set(YARN)
    assert CONFIG["reduced"] == [] and CONFIG["reference"] == "deepseek_v2"
    check_against_source(CONFIG)
    # the source's keys, as published, at the top level too
    assert all(CONFIG[k] == v for k, v in pub.items())
    cfg = model_config(CONFIG)
    shapes = {leaf: shape[1:] if weights.stacked(kind) else shape
              for kind, shape, leaves, _, _ in weights.layout(m)
              for leaf in leaves}
    assert shapes == {k: d.shape for k, d in model_defs(cfg).items()}
    assert round(sum(int(np.prod(s)) for s in shapes.values()) / 1e9,
                 2) == 15.71
    assert manifest.reference(CONFIG) is deepseek_v2


P = "repro_torch."
# a prefill (0-4) holding two layers' sequence passes, then a decode step
# (5-9) holding two layers' decode attentions; three launches in the
# first decode attention, one in the second, one outside both
HOST = [(P + "engine.prefill", 0.0, 4.0), (P + "model.prefill", 0.5, 3.5),
        (P + "mla.sequence", 1.0, 1.5), (P + "mla.sequence", 2.0, 2.5),
        (P + "engine.decode", 5.0, 9.0), (P + "model.decode", 5.5, 8.5),
        (P + "mla.decode", 6.0, 6.5), (P + "mla.decode", 7.0, 7.5),
        ("cudaLaunchKernel", 6.1, 6.15), ("cuLaunchKernel", 6.2, 6.25),
        ("cudaLaunchKernelExC", 6.3, 6.35), ("cudaLaunchKernel", 7.1, 7.2),
        ("cudaLaunchKernel", 8.0, 8.1)]
# idle (1.1, 1.3) and (2.2, 2.3) in the sequence passes, (6.4, 6.45) in a
# decode attention, (3.0, 3.2) in the model's prefill outside them
BUSY = [(0.0, 1.1), (1.3, 2.2), (2.3, 3.0), (3.2, 6.4), (6.45, 10.0)]


def _read(name, host, busy=BUSY, kind="serve"):
    return manifest.reader(name)({"kind": kind, "trace": Trace(
        (0.0, 10.0), [("kernel", a, b) for a, b in busy], host)})


def test_the_mla_span_readers():
    assert _read("idle_mla_share.serve", HOST) == pytest.approx(
        100.0 * (0.2 + 0.1 + 0.05) / 10.0)
    assert _read("launches_per_mla_decode.serve", HOST) == 2.0
    bare = [x for x in HOST if not x[0].startswith(P + "mla.")]
    for name in ("idle_mla_share.serve", "launches_per_mla_decode.serve"):
        assert _read(name, bare) is None
        assert _read(name, HOST, kind="train") is None
    # decode spans alone: the share is read, the launches too; sequence
    # spans alone: the share is read, no decode attention to count over
    dec = [x for x in HOST if x[0] != P + "mla.sequence"]
    assert _read("idle_mla_share.serve", dec) == pytest.approx(0.5)
    seq = [x for x in HOST if x[0] != P + "mla.decode"]
    assert _read("launches_per_mla_decode.serve", seq) is None
    assert _read("idle_mla_share.serve", seq) == pytest.approx(3.0)
    # spans the device was never idle in: a share of 0, not None
    assert _read("idle_mla_share.serve", HOST, busy=[(0.0, 10.0)]) == 0.0


def test_a_traced_tiny_cell_reads_the_mla_spans(tmp_path):
    """The kind's run on a tiny DeepSeek-V2 cell made as files: the engine
    and the reference this configuration names, the MLA spans opened once
    a layer in every prefill and decode step, both new readers read."""
    from cellbench.kinds import serve_closed
    root = testing.make_root(tmp_path)
    b = root / "bench"
    (b / "configs" / "tiny-dsv2.json").write_text(json.dumps(TINY))
    traffic = json.loads((b / "traffic" / "tiny-serve.json").read_text())
    traffic.update(prompt={"dist": "lognormal", "median": 24, "sigma": 0.45,
                           "min": 17, "max": 40}, sample_requests=4,
                   trace_seconds=1.0)
    (b / "traffic" / "tiny-longctx.json").write_text(json.dumps(traffic))
    (b / "limits" / "tiny-dsv2.serve.json").write_text(
        json.dumps({"limits": {"served_gap_mean": 1.5e-3}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dsv2", "source": "test",
                            "reduced": [], "why": "test",
                            "file": "bench/configs/tiny-dsv2.json"})
    spec["workloads"].append({"name": "tiny-dsv2.serve",
                              "config": "tiny-dsv2",
                              "traffic": "tiny-longctx", "chips": 1,
                              "why": "test"})
    for mt in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in mt and "tiny-moe.serve" in mt["workloads"]:
            mt["workloads"].append("tiny-dsv2.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = manifest.load_cell(root, "tiny-dsv2.serve")
    assert {"idle_mla_share.serve", "launches_per_mla_decode.serve"} <= {
        mt["name"] for mt in cell.per_layer}
    out = serve_closed.run(cell, 2 ** 31 + 11, 1.0, True, "cpu")
    ctx = out["ctx"]
    names = [n for n, _, _ in attribution.spans(ctx["trace"])]
    n_layers = TINY["model"]["n_layers"]
    assert names.count("mla.sequence") == n_layers * len(
        ctx["traced"]["prefill_lengths"])
    assert names.count("mla.decode") == n_layers * len(
        ctx["traced"]["decode_rows"]) > 0
    # the CPU trace holds no device interval: the stretch is one idle gap,
    # charged whole to the innermost span around its midpoint
    mid = sum(ctx["trace"].window) / 2
    in_mla = any(n.startswith("mla.") and a <= mid <= b
                 for n, a, b in attribution.spans(ctx["trace"]))
    assert manifest.reader("idle_mla_share.serve")(ctx) == pytest.approx(
        100.0 if in_mla else 0.0)
    # nor any CUDA runtime call
    assert manifest.reader("launches_per_mla_decode.serve")(ctx) == 0.0
    assert out["checks"]["served_gap_mean"]["value"] < 1.5e-3
