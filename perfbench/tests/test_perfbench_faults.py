"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card (the tiny
fixture's cells on the CPU) with one fault planted in the port: a decode
step that leaves its state (the KV cache) unchanged; half of the decode
batch (every other slot) left out, its logits the mean over the rest;
the same confined to the slots at or above a decode step's capacity
(``tiny-wide``: 24 slots, capacity 16); a token altered where the
sampler produces it; logits shifted and scaled where the model returns
them, each row's best token kept.  The cells run on one card, so no
exchange between cards can be left out.  The same runs without a fault
are correct.
"""

import time

import pytest
import torch

from perfbench import harness

SEED = 2**32 + 11
NUMBERS = ["logit_err_mean", "gap_mean", "compared", "logits_compared",
           "failed", "short"]


def _run(root, cell="tiny-gen"):
    torch.manual_seed(0)
    return harness.run(root, cell, SEED, 3.0, False, "cpu",
                       time.perf_counter(), say=lambda *_: None)


def _over(r) -> list[str]:
    return [k for k, v in r["checks"].items()
            if k in ("logit_err_mean", "gap_mean")
            and not v["value"] <= v["limit"]]


@pytest.mark.parametrize("cell", ["tiny-chat", "tiny-gen", "tiny-wide"])
def test_sound_run_is_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == NUMBERS


def test_state_left_unchanged(tiny_root, monkeypatch):
    from repro_torch.models.layers import attention

    orig = attention.decode_step

    def frozen(params, x, cache, cache_len, cfg):
        y, _ = orig(params, x, {k: v.clone() for k, v in cache.items()},
                    cache_len, cfg)
        return y, cache

    monkeypatch.setattr(attention, "decode_step", frozen)
    r = _run(tiny_root)
    assert not r["correct"] and _over(r), r["checks"]


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    from repro_torch.models.transformer import Model

    orig = Model.decode_step

    def half(self, tokens, cache, cache_len):
        logits, cache = orig(self, tokens, cache, cache_len)
        logits[0::2] = logits[1::2].mean(0)
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", half)
    r = _run(tiny_root)
    assert not r["correct"] and _over(r), r["checks"]


def test_half_the_batch_left_out_above_the_capacity(tiny_root, monkeypatch):
    """Only the slots that a decode step's capacity can drop (16-23 of
    24) lose their rows, the mean of the others in their place: the
    check samples every slot, so it sees them."""
    from repro_torch.models.transformer import Model

    cell = harness.find(tiny_root, "tiny-wide")
    n, cap = cell.traffic["n_slots"], cell.dims.capacity(
        cell.traffic["n_slots"])
    assert cap < n
    orig = Model.decode_step

    def high(self, tokens, cache, cache_len):
        logits, cache = orig(self, tokens, cache, cache_len)
        logits[cap:] = logits[:cap].mean(0)
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", high)
    r = _run(tiny_root, "tiny-wide")
    assert not r["correct"] and _over(r), r["checks"]


def test_token_altered_where_produced(tiny_root, monkeypatch):
    from repro_torch.serving import sampler

    orig = sampler.greedy
    calls = [0]

    def altered(logits):
        tok = orig(logits)
        calls[0] += 1
        if calls[0] % 3 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(sampler, "greedy", altered)
    r = _run(tiny_root)
    assert not r["correct"] and _over(r), r["checks"]


def test_logits_moved_with_the_same_best_token(tiny_root, monkeypatch):
    """Every served token stays the one the program ranks first (the
    gaps cannot see it); the logits the check compares are wrong."""
    from repro_torch.models.transformer import Model

    orig = Model.decode_step

    def moved(self, tokens, cache, cache_len):
        logits, cache = orig(self, tokens, cache, cache_len)
        return 1.5 * logits + 1.0, cache

    monkeypatch.setattr(Model, "decode_step", moved)
    r = _run(tiny_root)
    assert not r["correct"] and _over(r) == ["logit_err_mean"], r["checks"]
