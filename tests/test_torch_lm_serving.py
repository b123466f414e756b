"""The port's LM serving engine, after the JAX package's
``tests/test_serving.py``: a batch of requests, continuous batching
equal to one-at-a-time greedy decoding, slot reuse, EOS, and greedy
outputs equal to the JAX engine's on the same params (float32, reduced
configs, on the CPU), for the attention-only archs and for the MoE,
SSM and hybrid ones (mixtral, grok-1, rwkv6, jamba); the serving CLIs
for every registered LM config."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.transformer import Model as JModel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from repro_torch.serving import Request, ServingEngine


def _engine(arch="starcoder2-3b", n_slots=3, max_len=64):
    cfg = reduced(get_config(arch))
    model = Model(cfg, torch.float32, attn_chunk=16, device="cpu")
    return cfg, model, ServingEngine(model, n_slots=n_slots, max_len=max_len)


def test_engine_serves_batch_of_requests():
    cfg, model, eng = _engine()
    reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=5)
            for i in range(5)]  # more requests than slots
    done = eng.run(reqs, max_steps=200)
    assert all(r.done for r in done)
    for r in done:
        assert len(r.output) == 5
        assert all(0 <= t < cfg.vocab_padded for t in r.output)
    assert eng.tokens_out == 25
    assert ops.launch_counts()["flash_attention"] == 0   # the CPU: plain


def test_engine_matches_sequential_greedy():
    """Continuous-batched greedy decode == one-at-a-time greedy decode."""
    cfg, model, eng = _engine(n_slots=2)
    prompts = [[5, 6, 7], [9, 8, 7, 6]]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs, max_steps=100)
    for req, prompt in zip(reqs, prompts):
        logits, cache, clen = model.prefill(torch.tensor([prompt]), 64)
        out = [int(torch.argmax(logits[0]))]
        for _ in range(3):
            logits, cache = model.decode_step(torch.tensor([[out[-1]]]),
                                              cache, clen)
            clen += 1
            out.append(int(torch.argmax(logits[0])))
        assert req.output == out, (req.output, out)


def test_engine_slot_reuse():
    cfg, model, eng = _engine(n_slots=1)
    reqs = [Request(rid=i, prompt=[i + 1, i + 2], max_new_tokens=3)
            for i in range(3)]
    eng.run(reqs, max_steps=200)
    assert all(r.done for r in reqs)


def test_engine_eos_stops_early():
    cfg, model, eng = _engine()
    logits, _, _ = model.prefill(torch.tensor([[1, 2, 3]]), 64)
    eos = int(torch.argmax(logits[0]))
    req = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=50, eos_id=eos)
    eng.run([req], max_steps=100)
    assert req.done and len(req.output) == 1  # stopped on first token


def test_engine_stops_at_the_cache_end():
    cfg, model, eng = _engine(n_slots=1, max_len=8)
    req = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=50)
    eng.run([req], max_steps=100)
    assert req.done and len(req.output) == 5   # cache_len reached 7


@pytest.mark.parametrize("prompt", [[], [1, 512], [-1], list(range(64))])
def test_engine_refuses_prompts_the_model_cannot_take(prompt):
    cfg, model, eng = _engine()
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=prompt))
    assert not eng.queue


def test_temperature_sampling_is_seeded():
    outs = []
    for _ in range(2):
        _, _, eng = _engine(n_slots=2)
        eng.temperature = 0.8
        reqs = [Request(rid=i, prompt=[4, 5, 6 + i], max_new_tokens=6)
                for i in range(3)]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch,n_slots,max_len", [("gemma3-1b", 3, 40),
                                                  ("starcoder2-3b", 2, 64)])
def test_greedy_outputs_equal_the_jax_engines(arch, n_slots, max_len):
    """Ragged prompts (gemma3-1b's longer than its 16-token window),
    more requests than slots, an EOS taken from the JAX run: the port
    serves the JAX params to the same tokens."""
    jcfg = jreduced(jget_config(arch))
    jmodel = JModel(jcfg, dtype=jnp.float32, attn_chunk=16)
    params = jmodel.init_params(jax.random.key(1))
    model = Model(reduced(get_config(arch)), torch.float32, attn_chunk=16,
                  device="cpu", seed=None)
    convert.lm_params_from_jax(model, params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (5, 19, 2, 11, 23)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=7)
             for i, p in enumerate(prompts)]
    JServingEngine(jmodel, params, n_slots=n_slots,
                   max_len=max_len).run(jreqs, max_steps=300)
    eos = jreqs[1].output[3]
    jeos = JRequest(rid=9, prompt=prompts[1], max_new_tokens=7, eos_id=eos)
    JServingEngine(jmodel, params, n_slots=n_slots,
                   max_len=max_len).run([jeos], max_steps=300)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=7)
            for i, p in enumerate(prompts)]
    reqs.append(Request(rid=9, prompt=prompts[1], max_new_tokens=7,
                        eos_id=eos))
    eng = ServingEngine(model, n_slots=n_slots, max_len=max_len)
    eng.run(reqs[:-1], max_steps=300)
    ServingEngine(model, n_slots=n_slots, max_len=max_len).run(
        reqs[-1:], max_steps=300)
    assert [r.output for r in reqs] == [r.output for r in jreqs + [jeos]]
    assert reqs[-1].output[-1] == eos and len(reqs[-1].output) <= 4


@pytest.mark.parametrize("n_slots", [2, 4])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b",
                                  "mixtral-8x22b", "grok-1-314b"])
def test_families_greedy_outputs_equal_the_jax_engines(arch, n_slots):
    """Ragged prompts, more requests than slots: every slot decodes every
    step, empty ones too, so the MoE layers route (and take capacity
    for) the empty slots' tokens as the JAX engine's do; the recurrent
    states are spliced into their slots and run on."""
    jcfg = jreduced(jget_config(arch))
    jmodel = JModel(jcfg, dtype=jnp.float32, attn_chunk=16)
    params = jmodel.init_params(jax.random.key(2))
    model = Model(reduced(get_config(arch)), torch.float32, attn_chunk=16,
                  device="cpu", seed=None)
    convert.lm_params_from_jax(model, params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (5, 19, 3, 11, 8)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    JServingEngine(jmodel, params, n_slots=n_slots,
                   max_len=40).run(jreqs, max_steps=300)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng = ServingEngine(model, n_slots=n_slots, max_len=40)
    eng.run(reqs, max_steps=300)
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-1.5-large-398b",
                                  "whisper-small", "internvl2-26b"])
def test_serve_cli_serves_every_family_on_the_cpu(arch):
    """``launch/serve.py --arch`` takes every registered LM config: the
    decoder-only ones through the engine, whisper and internvl2 through
    ``Model.prefill``/``decode_step`` with stub frames or patches."""
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--requests", "3", "--slots", "2",
         "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"{arch}-smoke: 3/3 done, 12 tokens" in proc.stdout


def test_serve_lm_cli_mirrors_the_examples_flags():
    """``launch/serve_lm.py``, the counterpart of
    ``examples/serve_lm.py``: the same flags and defaults, a reduced
    config in float32, every request done."""
    import ast

    root = Path(__file__).resolve().parents[1]

    def flags(path):
        tree = ast.parse(path.read_text())
        return {node.args[0].value: next(
            (ast.literal_eval(kw.value) for kw in node.keywords
             if kw.arg == "default"), None)
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and node.args
            and isinstance(node.args[0], ast.Constant)
            and str(node.args[0].value).startswith("--")}

    mine = flags(root / "src" / "repro_torch" / "launch" / "serve_lm.py")
    theirs = flags(root / "examples" / "serve_lm.py")
    assert {k: mine[k] for k in theirs} == theirs
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
         "grok-1-314b", "--device", "cpu", "--requests", "5", "--slots",
         "2", "--max-new", "3", "--temperature", "0.7"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "completed 5/5 requests" in proc.stdout
    assert "(15 tokens," in proc.stdout
    if not torch.cuda.is_available():       # no --device: the card or stop
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_lm",
             "--requests", "1"],
            capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_serve_cli_serves_a_reduced_lm_on_the_cpu():
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--device", "cpu", "--requests", "4", "--slots", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "gemma3-1b-smoke: 4/4 done, 32 tokens" in proc.stdout
    assert "dtype=torch.float32, flash_attention launches 0" in proc.stdout


def test_serve_cli_max_new_sets_tokens_per_request():
    """``--max-new`` is the JAX CLI's flag with its default (8): 3 asks
    for 3 tokens a request."""
    import ast

    tree = ast.parse((Path(__file__).resolve().parents[1] / "src" / "repro"
                      / "launch" / "serve.py").read_text())
    jax_default = [
        kw.value.value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and node.args
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "--max-new"
        for kw in node.keywords if kw.arg == "default"]
    assert jax_default == [8]
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--reduced", "--device", "cpu", "--requests", "3",
         "--slots", "2", "--max-new", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "gemma3-1b-smoke: 3/3 done, 9 tokens" in proc.stdout
