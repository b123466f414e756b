"""The plain reference against the port, at a reduced size on the CPU.

The port's model in float32 (the bf16 weights the benchmark draws,
widened) and the float32 reference agree to rounding on a prefill and on
decode steps through the cache, with the capacity drops of the prefill
both at the configured factor and at one low enough to drop many pairs.
A served run's check, on a float32 engine, reads gaps of rounding.
"""

import dataclasses

import pytest
import torch

from perfbench import checks, harness, sizes, traffic, weights
from perfbench.capture import Capture
from perfbench.reference import moe_lm


def _models(root, seed, capacity_factor=None):
    cell = harness.find(root, "tiny-chat")
    if capacity_factor is not None:
        cell.config["port"]["capacity_factor"] = capacity_factor
        cell = dataclasses.replace(cell, dims=dataclasses.replace(
            cell.dims, capacity_factor=capacity_factor))
    model = harness.build_model(cell, seed, "cpu").cast(torch.float32)
    return cell, model


def _ref(cell, seed, seq, prompt_len):
    d = cell.dims

    def layer(i):
        p = f"layers.{i}."
        return {n[len(p):]: weights.draw(n, s, seed, "cpu")
                for n, s in weights.layer_specs(d, i).items()}

    def outer():
        return {n: weights.draw(n, s, seed, "cpu")
                for n, s in weights.outer_specs(d).items()}

    return moe_lm.logits(d, [seq], [[(0, prompt_len)]], layer, outer,
                         [list(range(prompt_len - 1, len(seq)))])[0]


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_prefill_and_decode_match_the_reference(tiny_root, capacity_factor):
    seed = 2**33 + 5
    cell, model = _models(tiny_root, seed, capacity_factor)
    g = torch.Generator().manual_seed(0)
    seq = torch.randint(0, cell.dims.vocab, (60,), generator=g)
    p = 48
    ref = _ref(cell, seed, seq, p)
    got = []
    with torch.no_grad():
        logits, cache, clen = model.prefill(seq[None, :p], 64)
        got.append(logits[0])
        for t in range(p, len(seq)):
            logits, cache = model.decode_step(seq[None, t:t + 1], cache,
                                              torch.tensor([t]))
            got.append(logits[0])
    got = torch.stack(got)
    scale = ref.abs().max()
    assert torch.allclose(got, ref, atol=1e-4 * scale, rtol=0)
    if capacity_factor == 0.5:
        h = torch.randn(p, cell.dims.d_model, generator=g)
        router = weights.draw("layers.0.ffn.router",
                              weights.layer_specs(cell.dims, 0)[
                                  "layers.0.ffn.router"], seed, "cpu")
        _, idx = moe_lm.route(h, router, cell.dims.top_k)
        keep = moe_lm.kept(idx, [(0, p)], cell.dims.n_experts,
                           cell.dims.capacity)
        assert not keep.all()


def test_capacity_rule():
    d = sizes.Dims(8, 8, 1, 1, 1, 8, 8, 2, 8, 1.0, 1e-6, None, 1.25)
    assert [d.capacity(n) for n in (1, 4, 32, 100, 1024)] == \
        [8, 8, 16, 32, 320]
    idx = torch.tensor([[0, 1]] * 20)
    keep = moe_lm.kept(idx, [(0, 20)], 8, lambda n: 8)
    assert keep[:8].all() and not keep[8:].any()
    assert moe_lm.kept(idx, [], 8, lambda n: 8).all()


def test_served_float32_engine_reads_rounding_gaps(tiny_root):
    """A float32 engine's served tokens and kept logits, in every slot,
    read rounding against the reference: gaps and logit errors both."""
    seed = 77
    cell, model = _models(tiny_root, seed)
    params = cell.traffic
    eng = harness.engine_for(model, params)
    capture = Capture(seed, 1)
    capture.install(eng)
    log = harness.drive(eng, traffic.Traffic(params, seed, cell.dims.vocab,
                                             3.0),
                        params, 3.0, capture=capture)
    capture.uninstall()
    done = [f for f in log.flights if f.req.done]
    picked = checks.sample(done, 4, seed)
    longest = max(done, key=lambda f: (len(f.spec.tokens)
                                       + len(f.req.output), f.spec.index))
    assert picked and picked[0] is longest
    refs = checks.reference_logits(cell.dims, seed, picked, "cpu")
    got = checks.compare(refs, [f.req.output for f in picked],
                         [capture.of(f.spec.index) for f in picked])
    assert got["compared"] >= 8
    assert got["logits_compared"] == got["compared"]
    assert got["widest"]["gap"] < 1e-3 and got["widest"]["logit_err"] < 1e-3
