"""The port's LM in bfloat16 against the JAX package's in bfloat16, on
the CPU: reduced configs, the JAX params carried over by
``convert.lm_params_from_jax``, B 2, a 21-token prefill, then 6 decode
steps fed JAX's greedy tokens.

Both run bf16 activations with float32 logits, but round and sum in
other orders (XLA keeps some bf16 chains in float32; PyTorch rounds
every op), so each is a few bf16 roundings from the same weights run in
float32: up to 3.4% of the logits' scale for JAX's jamba and 3.0% for
the port's (the largest |logit| of the call; 1.2-1.8% for gemma3-1b).
Their logits are held within ``LOGIT_TOL`` = 2^-4 of the scale, the sum
of two such errors.  Within it a greedy token can flip only where JAX's
two best logits lie within 2 x ``LOGIT_TOL``: the tokens are held equal
wherever they lie farther apart, and the near ties printed.

MoE routing (mixtral, jamba): each side's experts from its own MoE
input, recorded per MoE call (the port's ``moe.route``; JAX's
``repro.models.layers.moe.forward`` wrapped here, its probabilities
computed from its input as it computes them and read back through
``jax.debug.callback``).  bf16 moves a router probability by up to
0.019 in the tokens compared (jamba; 0.006 for mixtral), so the expert
sets are held equal wherever JAX's k-th and (k+1)-th probabilities
differ by more than ``ROUTE_MARGIN`` (0.05); below it a flip is counted
and printed.  A flipped token's own later layers and every later token
of its sequence (attention and the Mamba state carry it) are past the
comparison, and so are the other tokens of a call whose (token, slot)s
kept within capacity then differ: their logits and routes are not held.

jamba's outlier: the sequence whose prefill logits differ most from
JAX's (2.86 at a scale of 3.34 here) went past such a flip, and with
JAX's experts forced on the port's routing every logit is back within
``LOGIT_TOL``: an expert flip at a near tie, not a port fault.  The
test prints that sequence's distance from the port's float32 run of the
same weights, for both bf16 runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.layers import moe as jmoe
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models.layers import moe
from repro_torch.models.transformer import Model

B, T, STEPS, MAX_LEN = 2, 21, 6, 40
LOGIT_TOL = 2.0 ** -4
ROUTE_MARGIN = 0.05
DENSE = ["gemma3-1b", "starcoder2-3b", "rwkv6-7b"]
MOE = ["mixtral-8x22b", "jamba-1.5-large-398b"]


def _run(arch: str, forced: tuple | None = None, dtype=torch.bfloat16
         ) -> dict:
    """The port and JAX in bf16 on the same params and tokens: the logits
    of the prefill and of every decode step (f32 [B, Vp] each), and
    every MoE call's router probabilities [N, E] on each side.
    ``forced``: JAX's experts of each MoE call (int[N, k]), put in place
    of the port's own choice.  ``dtype``: the port's (float32: the same
    bf16 weights run in float32)."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jmodel = JModel(jcfg, dtype=jnp.bfloat16, attn_chunk=16)
    params = jmodel.init_params(jax.random.key(0))
    model = Model(cfg, dtype, attn_chunk=16, device="cpu", seed=None)
    convert.lm_params_from_jax(model, params)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    j_probs, p_probs = [], []
    j_forward, p_route = jmoe.forward, moe.route

    def j_recorded(p, x, c):
        probs = jax.nn.softmax(
            x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"],
            axis=-1)
        jax.debug.callback(lambda a: j_probs.append(np.asarray(a)), probs,
                           ordered=True)
        return j_forward(p, x, c)

    def p_recorded(p, xf, c):
        probs, gate, idx = p_route(p, xf, c)
        if forced is not None:
            idx = torch.from_numpy(forced[len(p_probs)]).to(torch.int64)
            gate = probs.gather(-1, idx)
            gate = gate / gate.sum(dim=-1, keepdim=True)
        p_probs.append(probs.numpy())
        return probs, gate, idx

    jmoe.forward, moe.route = j_recorded, p_recorded
    try:
        logits, cache, n = model.prefill(torch.from_numpy(toks), MAX_LEN)
        jlogits, jcache, jn = jmodel.prefill(
            params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
        got, want = [logits.float().numpy()], [np.asarray(jlogits)]
        for step in range(STEPS):
            nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
            logits, cache = model.decode_step(torch.from_numpy(nxt), cache,
                                              n + step)
            jlogits, jcache = jmodel.decode_step(params, jnp.asarray(nxt),
                                                 jcache, jn + step)
            got.append(logits.float().numpy())
            want.append(np.asarray(jlogits))
        jax.effects_barrier()
    finally:
        jmoe.forward, moe.route = j_forward, p_route
    return {"got": got, "want": want, "p_probs": p_probs,
            "j_probs": j_probs, "moe_cfg": model.moe_cfg()
            if cfg.n_experts else None}


@functools.lru_cache(maxsize=None)
def _runs(arch: str) -> dict:
    return _run(arch)


def _top_k(probs: np.ndarray, k: int) -> np.ndarray:
    """The k largest of each row, ties to the lower index (as
    ``lax.top_k`` and the port's stable sort)."""
    return np.argsort(-probs, axis=-1, kind="stable")[:, :k]


def _kept(idx: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The (token, slot)s within their expert's capacity (the cumsum of
    both packages' dispatch, token-major)."""
    onehot = np.eye(n_experts, dtype=np.int64)[idx]               # [N, k, E]
    pos = np.cumsum(onehot.reshape(-1, n_experts), 0).reshape(onehot.shape)
    return ((pos - 1) * onehot).sum(-1) < cap


def _tokens_off(got, want) -> list:
    """(call, sequence, JAX's top-2 logit gap, tolerance) of every greedy
    token that differs."""
    out = []
    for c, (g, w) in enumerate(zip(got, want)):
        top = -np.sort(-w, axis=-1)
        tol = LOGIT_TOL * np.abs(w).max()
        for s in np.nonzero(g.argmax(-1) != w.argmax(-1))[0]:
            out.append((c, int(s), float(top[s, 0] - top[s, 1]), tol))
    return out


def _routes(run: dict) -> dict:
    """Per MoE call, the tokens compared (not past a flip), the flips
    among them (token, JAX's k-th minus (k+1)-th probability) and the
    sequences past a flip after the call; prefill calls see every token
    (N = B * T), a decode step's calls one a sequence."""
    cfg = run["moe_cfg"]
    k, e = cfg.top_k, cfg.n_experts
    past = np.zeros(B, bool)        # a sequence past a flip
    calls = []
    for pp, jp in zip(run["p_probs"], run["j_probs"]):
        n = pp.shape[0]
        seq = np.arange(n) // (n // B)
        pi, ji = _top_k(pp, k), _top_k(jp, k)
        top = -np.sort(-jp, axis=-1)
        gap = top[:, k - 1] - top[:, k]
        cap = moe.capacity(n, cfg)
        differs = ((np.sort(pi, -1) != np.sort(ji, -1)).any(-1)
                   | (_kept(pi, e, cap) != _kept(ji, e, cap)).any(-1))
        clean = ~past[seq]
        flips = [(int(i), float(gap[i])) for i in np.nonzero(clean
                                                             & differs)[0]]
        calls.append({"clean": clean, "flips": flips, "gap": gap,
                      "max_dprob": float(np.abs(pp - jp)[clean].max(
                          initial=0.0))})
        past |= np.isin(np.arange(B), seq[clean & differs])
    return {"calls": calls, "past": past}


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_logits_and_greedy_tokens_match_jax(arch):
    run = _runs(arch)
    for c, (g, w) in enumerate(zip(run["got"], run["want"])):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= LOGIT_TOL * scale, (c, scale)
    off = _tokens_off(run["got"], run["want"])
    print(f"{arch}: greedy tokens off at near ties (call, sequence, JAX's "
          f"top-2 gap, tolerance): {off}")
    assert all(gap <= 2 * tol for _, _, gap, tol in off), off


@pytest.mark.parametrize("arch", MOE)
def test_bf16_moe_experts_match_jax_above_the_margin(arch):
    run = _runs(arch)
    routes = _routes(run)
    calls = routes["calls"]
    assert len(calls) == len(run["j_probs"]) > 0
    flips = [(c, f) for c, r in enumerate(calls) for f in r["flips"]]
    above = sum(int((r["gap"][r["clean"]] > ROUTE_MARGIN).sum())
                for r in calls)
    print(f"{arch}: expert flips (call, (token, JAX's k-th minus (k+1)-th "
          f"probability)): {flips}; sequences past a flip "
          f"{np.nonzero(routes['past'])[0].tolist()}; largest probability "
          f"gap of the compared tokens "
          f"{max(r['max_dprob'] for r in calls)}; tokens compared above the "
          f"margin {above} of {sum(int(r['clean'].sum()) for r in calls)}")
    assert all(gap <= ROUTE_MARGIN for _, (_, gap) in flips), flips
    assert max(r["max_dprob"] for r in calls) < ROUTE_MARGIN / 2
    # the sequences no flip reached: logits within the tolerance, greedy
    # tokens equal but at near ties
    clean = ~routes["past"]
    for c, (g, w) in enumerate(zip(run["got"], run["want"])):
        scale = np.abs(w).max()
        assert np.abs(g - w)[clean].max(initial=0.0) <= LOGIT_TOL * scale
    off = [o for o in _tokens_off(run["got"], run["want"]) if clean[o[1]]]
    assert all(gap <= 2 * tol for _, _, gap, tol in off), off


def test_jamba_bf16_outlier_is_an_expert_flip():
    """The sequence of the largest prefill gap went past a flip below the
    margin; with JAX's experts forced, every logit is within the
    tolerance."""
    arch = "jamba-1.5-large-398b"
    run = _runs(arch)
    g, w = run["got"][0], run["want"][0]
    worst = int(np.abs(g - w).max(-1).argmax())
    scale = np.abs(w).max()
    assert np.abs(g - w)[worst].max() > LOGIT_TOL * scale
    routes = _routes(run)
    assert routes["past"][worst]
    flips = [gap for r in routes["calls"] if len(r["gap"]) == B * T
             for tok, gap in r["flips"] if tok // T == worst]
    assert flips and max(flips) <= ROUTE_MARGIN, flips
    forced = [_top_k(jp, run["moe_cfg"].top_k) for jp in run["j_probs"]]
    again = _run(arch, forced=tuple(forced))
    gaps = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(again["got"], again["want"])]
    f32 = _run(arch, dtype=torch.float32)["got"][0][worst]
    print(f"{arch}: prefill gap of sequence {worst} "
          f"{float(np.abs(g - w)[worst].max())} at scale {scale}; from the "
          f"port's float32 run, the port's bf16 "
          f"{float(np.abs(g[worst] - f32).max())}, JAX's "
          f"{float(np.abs(w[worst] - f32).max())}; with JAX's experts, the "
          f"largest gap by call over the scale {gaps}")
    assert max(gaps) <= LOGIT_TOL
