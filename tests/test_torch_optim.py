"""The port's optimizer stack against the JAX package's, on the CPU:
the cosine schedule (float32, within 4 ulp: torch's and XLA's float32
cos differ in the last bit for some 6% of arguments, and the schedule's
later float32 operations carry that), AdamW (clip, bias correction, decay mask, the
sliced large-leaf path, bf16 states; rtol 1e-6 of each leaf's largest
magnitude), stochastic rounding (bit-exact given JAX's own noise;
unbiased with torch's), 1-bit compression (sign words equal as uint32,
scale and error feedback at 1e-6), then the port's counterpart of every
``tests/test_optim.py`` case.  Inputs are numpy draws from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim.adamw import _stochastic_round_bf16 as j_sr
from repro.optim.compression import compress_tree as jcompress_tree
from repro.optim.compression import onebit_compress as jonebit_compress
from repro.optim.compression import onebit_decompress as jonebit_decompress
from repro_torch.core.bitpack import words_to_numpy
from repro_torch.optim import (AdamW, AdamWConfig, cosine_schedule,
                               onebit_compress, onebit_decompress)
from repro_torch.optim.adamw import (_stochastic_round_bf16,
                                     stochastic_round_bf16)
from repro_torch.optim.compression import (compress_tree, decompress_tree,
                                           init_error)

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    """Within rtol of the leaf's largest magnitude."""
    g = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float32))
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale)


# --- the schedule ---------------------------------------------------------------

@pytest.mark.parametrize("base,warm,total,ratio", [
    (3e-4, 5, 10, 0.1), (1.0, 10, 100, 0.1), (2e-3, 0, 37, 0.0),
    (0.1, 50, 60, 0.5)])
def test_cosine_schedule_equals_jax(base, warm, total, ratio):
    j, t = (jcosine_schedule(base, warm, total, ratio),
            cosine_schedule(base, warm, total, ratio))
    steps = range(total + 5)
    want = np.array([np.float32(j(s)) for s in steps])
    got = np.array([t(s).item() for s in steps], np.float32)
    assert all(t(s).dtype == torch.float32 for s in (0, total))
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    # a tensor step gives the same value as an int
    assert t(torch.tensor(3, dtype=torch.int32)).item() == t(3).item()


# --- AdamW against the JAX package --------------------------------------------

def _tree(rng, shapes, scale=1.0):
    return {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (8, 6), "b": (6,), "stack": (3, 4, 5), "s": ()}


def _run_both(jcfg: dict, cfg: dict, n_steps: int, grad_scale=1.0,
              threshold=None, seed=0):
    """``n_steps`` AdamW steps on the same params and grads through both
    packages: ((jax params, jax state), (port params, port state))."""
    rng = np.random.default_rng(seed)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, grad_scale) for _ in range(n_steps)]
    jopt, opt = JAdamW(JAdamWConfig(**jcfg)), AdamW(AdamWConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    jorig, orig = JAdamW._SCAN_THRESHOLD, AdamW._SCAN_THRESHOLD
    try:
        if threshold is not None:
            JAdamW._SCAN_THRESHOLD = AdamW._SCAN_THRESHOLD = threshold
        for g in grads:
            jp, js = jopt.apply({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
            tp, ts = opt.apply({k: torch.from_numpy(v.copy())
                                for k, v in g.items()}, ts, tp)
    finally:
        JAdamW._SCAN_THRESHOLD, AdamW._SCAN_THRESHOLD = jorig, orig
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("case", [
    dict(name="one step", n=1, cfg={}),
    dict(name="clip active", n=3, cfg={"grad_clip": 0.5}, gscale=10.0),
    dict(name="no clip, no decay", n=4,
         cfg={"grad_clip": 1e9, "weight_decay": 0.0, "lr": 1e-2}),
    dict(name="decay mask", n=5, cfg={"weight_decay": 0.5, "lr": 0.05}),
    dict(name="sliced large leaf", n=3, cfg={"lr": 1e-2}, threshold=1),
    dict(name="bf16 states", n=4, cfg={"grad_clip": 1e9, "lr": 1e-3},
         bf16=True),
    dict(name="schedule", n=6, cfg={}, cosine=True),
], ids=lambda c: c["name"])
def test_adamw_equals_jax(case):
    jcfg, cfg = dict(case["cfg"]), dict(case["cfg"])
    if case.get("cosine"):
        jcfg["lr"] = jcosine_schedule(1e-2, 2, 6)
        cfg["lr"] = cosine_schedule(1e-2, 2, 6)
    if case.get("bf16"):
        jcfg["state_dtype"], cfg["state_dtype"] = jnp.bfloat16, \
            torch.bfloat16
    (jp, js), (tp, ts) = _run_both(jcfg, cfg, case["n"],
                                   case.get("gscale", 1.0),
                                   case.get("threshold"))
    assert int(ts["step"]) == int(js["step"]) == case["n"]
    assert ts["step"].dtype == torch.int32
    # bf16 states: a last-bit float32 difference may round m or v to the
    # neighbouring bf16 value (2^-8 of it)
    tol = 2.0 ** -8 if case.get("bf16") else RTOL
    for k in SHAPES:
        _close(tp[k], jp[k])
        _close(ts["m"][k], js["m"][k], tol)
        _close(ts["v"][k], js["v"][k], tol)
        want = torch.bfloat16 if case.get("bf16") else torch.float32
        assert ts["m"][k].dtype == ts["v"][k].dtype == want


def test_adamw_decays_only_matrices_and_leaves_its_inputs():
    """With a zero gradient only weight decay moves a leaf: leaves of
    ndim >= 2 shrink, vectors and scalars stay; the inputs are not
    changed in place."""
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.5))
    params = {"m": torch.ones(2, 2), "v": torch.ones(3), "s": torch.ones(())}
    keep = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    new, _ = opt.apply({k: torch.zeros_like(v) for k, v in params.items()},
                       state, params)
    assert torch.all(new["m"] < 1) and torch.equal(new["v"], params["v"])
    assert torch.equal(new["s"], params["s"])
    for k in params:
        assert torch.equal(params[k], keep[k])
    assert int(state["step"]) == 0


# --- stochastic rounding ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_round_bit_exact_given_jax_noise(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.standard_normal(5000).astype(np.float32),
        (1.0 + rng.random(2000) * 1e-2).astype(np.float32),
        np.float32([0.0, -0.0, 1e-40, -3.3895314e38, 65504.0])])
    key = jax.random.key(seed)
    noise = np.asarray(jax.random.bits(key, x.shape, dtype=jnp.uint32)
                       & jnp.uint32(0xFFFF))
    want = np.asarray(j_sr(jnp.asarray(x), key)).view(np.uint16)
    got = stochastic_round_bf16(torch.from_numpy(x),
                                torch.from_numpy(noise.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)


def test_stochastic_rounding_unbiased():
    x = torch.full((20000,), 1.0 + 1e-3, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    vals = _stochastic_round_bf16(x, gen).float().numpy()
    assert len(np.unique(vals)) == 2  # rounds to the two neighbours only
    np.testing.assert_allclose(vals.mean(), 1.0 + 1e-3, atol=2e-4)


def test_stochastic_rounding_training_progresses_in_bf16():
    """bf16 params + tiny LR: deterministic rounding loses every update;
    stochastic rounding makes progress (the paper's C3 insight)."""
    def run(stochastic):
        opt = AdamW(AdamWConfig(lr=2e-4, weight_decay=0.0,
                                state_dtype=torch.bfloat16,
                                stochastic_rounding=stochastic))
        params = {"w": torch.tensor(1.0, dtype=torch.bfloat16)}
        state = opt.init(params)
        gen = torch.Generator().manual_seed(1)
        for _ in range(300):
            g = {"w": params["w"].float() * 2.0}  # d/dw w^2
            params, state = opt.apply(g, state, params,
                                      rng=gen if stochastic else None)
        return float(params["w"].float())

    w_stoch, w_det = run(True), run(False)
    assert w_det > 0.995, w_det
    assert w_stoch < w_det - 0.01, (w_stoch, w_det)


def test_stochastic_rounding_requires_rng():
    opt = AdamW(AdamWConfig(stochastic_rounding=True))
    params = {"w": torch.ones(2, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="rng"):
        opt.apply({"w": torch.ones(2)}, opt.init(params), params)


# --- 1-bit compression against the JAX package ---------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 257, 1000])
def test_onebit_words_and_error_feedback_equal_jax(n):
    rng = np.random.default_rng(n)
    err, jerr = torch.zeros(n), jnp.zeros((n,), jnp.float32)
    for _ in range(4):
        g = rng.standard_normal(n).astype(np.float32)
        comp, err = onebit_compress(torch.from_numpy(g), err)
        jcomp, jerr = jonebit_compress(jnp.asarray(g), jerr)
        got = words_to_numpy(comp["bits"])
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, np.asarray(jcomp["bits"]))
        _close(comp["scale"], jcomp["scale"])
        _close(err, jerr)
        _close(onebit_decompress(comp, (n,), n),
               jonebit_decompress(jcomp, (n,), n))


def test_compress_tree_equals_jax():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((10, 3)).astype(np.float32),
             "b": rng.standard_normal(70).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    comp, err = compress_tree(tg, init_error(tg))
    jcomp, jerr = jcompress_tree({k: jnp.asarray(v) for k, v in
                                  grads.items()},
                                 {k: jnp.zeros(v.shape) for k, v in
                                  grads.items()})
    for k in grads:
        np.testing.assert_array_equal(words_to_numpy(comp[k]["bits"]),
                                      np.asarray(jcomp[k]["bits"]))
        _close(err[k], jerr[k])


# --- the port's counterparts of tests/test_optim.py ------------------------------

def test_adamw_converges_on_quadratic():
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.0))
    params = {"w": torch.tensor([2.0, -3.0, 5.0]), "b": torch.tensor([1.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {k: 2 * v for k, v in params.items()}
        params, state = opt.apply(g, state, params)
    assert float(sum((v ** 2).sum() for v in params.values())) < 1e-2


def test_adamw_bias_correction_first_step():
    opt = AdamW(AdamWConfig(lr=1e-1, grad_clip=1e9, weight_decay=0.0))
    params = {"w": torch.tensor([0.0])}
    params, _ = opt.apply({"w": torch.tensor([0.5])}, opt.init(params),
                          params)
    np.testing.assert_allclose(float(params["w"][0]), -0.1, rtol=1e-3)


def test_grad_clip_limits_update_norm():
    opt = AdamW(AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0))
    params = {"w": torch.ones(4)}
    p2, _ = opt.apply({"w": torch.full((4,), 1e6)}, opt.init(params),
                      params)
    assert torch.isfinite(p2["w"]).all()


def test_scanned_update_matches_flat():
    """Large stacked leaves (sliced path) == small-leaf math."""
    opt = AdamW(AdamWConfig(lr=0.01, weight_decay=0.0))
    big = {"w": torch.arange(4 * 64 * 64, dtype=torch.float32
                             ).reshape(4, 64, 64) / 1e4}
    g = {"w": torch.ones_like(big["w"]) * 0.1}
    orig = AdamW._SCAN_THRESHOLD
    try:
        AdamW._SCAN_THRESHOLD = 1
        p_scan, s_scan = opt.apply(g, opt.init(big), big)
    finally:
        AdamW._SCAN_THRESHOLD = orig
    p_flat, s_flat = opt.apply(g, opt.init(big), big)
    np.testing.assert_allclose(p_scan["w"].numpy(), p_flat["w"].numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(s_scan["m"]["w"].numpy(),
                               s_flat["m"]["w"].numpy(), rtol=1e-5,
                               atol=1e-7)


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup_steps=10, total_steps=100)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 1.0, rtol=1e-5)
    assert float(lr(100)) < 0.11
    assert float(lr(50)) < float(lr(20))


def test_onebit_roundtrip_preserves_sign_and_scale():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(257,))
                         .astype(np.float32))
    comp, _ = onebit_compress(g, torch.zeros_like(g))
    out = onebit_decompress(comp, g.shape, g.numel())
    nz = g != 0
    assert torch.equal(torch.sign(out[nz]), torch.sign(g[nz]))
    np.testing.assert_allclose(float(comp["scale"]), float(g.abs().mean()),
                               rtol=1e-5)


def test_error_feedback_bounds_accumulated_bias():
    g_true = torch.from_numpy(np.linspace(-1, 1, 64).astype(np.float32))
    err = torch.zeros_like(g_true)
    total = torch.zeros(64)
    n = 200
    for _ in range(n):
        comp, err = onebit_compress(g_true, err)
        total += onebit_decompress(comp, g_true.shape, 64)
    np.testing.assert_allclose((total / n).numpy(), g_true.numpy(), atol=0.1)
    assert float(err.abs().max()) < 20.0


def test_compress_tree_structure():
    grads = {"a": torch.ones(10), "c": -torch.ones(5)}
    comp, _ = compress_tree(grads, init_error(grads))
    out = decompress_tree(comp, grads)
    assert out["a"].shape == (10,) and out["c"].shape == (5,)
    assert (out["a"] > 0).all() and (out["c"] < 0).all()
