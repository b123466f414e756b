"""The port's versioned train-while-serving against the JAX package's.

The same refresh stream, probe set, policies and seeded faults go
through a JAX engine (``ref`` ops) and a port engine (plain versions),
both on the virtual clock: promotions, rejections (at the fingerprint
gate and the accuracy gate), stalled refreshes, crashes mid-save and
canary rollbacks must be the same, every SERVED count must equal the
plain oracle under the version that batch pinned, the ``state_dir``s
must hold the same bytes, and a ``state_dir`` that one package wrote
restores in the other with the same fingerprint.  Every comparison is
exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package loads core before engine)
from repro.engine import SNNEnginePlan as JPlan
from repro.loadgen.runner import make_clock as jmake_clock
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultSpec as JSpec
from repro.serving import SNNRefreshPolicy as JRefreshPolicy
from repro.serving import SNNRequest as JRequest
from repro.serving import SNNServingEngine as JServing
from repro.serving import SNNServingPolicy as JPolicy
from repro.serving import SNNWeightRefresher as JRefresher
from repro.serving import VersionedWeightStore as JStore
from repro_torch.convert import weights_to_numpy
from repro_torch.core.bitpack import as_words
from repro_torch.core.encoder import encode_windows_host
from repro_torch.engine import SNNEnginePlan
from repro_torch.kernels import ops
from repro_torch.loadgen.runner import make_clock
from repro_torch.serving import (FaultInjector, FaultSpec, SNNRefreshPolicy,
                                 SNNRequest, SNNServingEngine,
                                 SNNServingPolicy, SNNWeightRefresher,
                                 VersionedWeightStore, weight_fingerprint)

N_CLASSES, BLOCKS, N_IN, W, T = 4, 2, 64, 2, 16
N = N_CLASSES * BLOCKS
PLAN = dict(threshold=24, leak=2, w_exp=128, n_syn=N_IN, encode="kernel",
            cycle_backend="window", max_batch=4, t_chunk=8)
NEURON_CLASS = np.tile(np.arange(N_CLASSES), BLOCKS)
WALL_KEYS = ("mean_step_ms", "last_step_ms")


def _bank(seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, (N, W),
                                                dtype=np.uint32)


def _quadrant_data(n):
    """Linearly separable toy stream: class c lights up quadrant c."""
    labels = np.arange(n) % N_CLASSES
    inten = np.zeros((n, N_IN), np.uint8)
    for i, c in enumerate(labels):
        inten[i, c * 16:(c + 1) * 16] = 200
    return inten, labels


def _refresher(pkg, policy=None):
    inten, labels = _quadrant_data(64)
    pol = policy or dict(refresh_every=2, probe_size=16, refresh_samples=16)
    kw = dict(n_classes=N_CLASSES, probe_intensities=inten[:16],
              probe_labels=labels[:16], neuron_class=NEURON_CLASS,
              n_steps=T)
    if pkg == "jax":
        return JRefresher(JPlan(**PLAN), inten, labels,
                          policy=JRefreshPolicy(**pol), **kw)
    return SNNWeightRefresher(SNNEnginePlan(kernel_backend="ref", **PLAN),
                              inten, labels, policy=SNNRefreshPolicy(**pol),
                              device="cpu", **kw)


def _engine(pkg, *, spec=None, hook=None, refresh=None, policy=None,
            state_dir=None, refresher=True, seed_bank=0, keep=64):
    pol = policy or {}
    inj = None
    if spec is not None:
        inj = JInjector(JSpec(**spec)) if pkg == "jax" else \
            FaultInjector(FaultSpec(**spec))
    kw = dict(neuron_class=NEURON_CLASS, on_launch=hook or inj,
              state_dir=state_dir, keep_versions=keep,
              refresher=_refresher(pkg, refresh) if refresher else None)
    if pkg == "jax":
        return JServing(jnp.asarray(_bank(seed_bank)), JPlan(**PLAN),
                        policy=JPolicy(**pol), clock=jmake_clock("virtual"),
                        **kw)
    return SNNServingEngine(_bank(seed_bank), SNNEnginePlan(
        kernel_backend="ref", **PLAN), policy=SNNServingPolicy(**pol),
        clock=make_clock("virtual"), device="cpu", **kw)


def _requests(pkg, n):
    inten, _ = _quadrant_data(64)
    cls = JRequest if pkg == "jax" else SNNRequest
    return [cls(rid=i, intensities=inten[i % 64], n_steps=T)
            for i in range(n)]


def _oracle(weights, r):
    win = encode_windows_host(r.seed, torch.from_numpy(r.intensities)[None],
                              r.n_steps, W)
    return ops.infer_window_batch(as_words(weights).cpu(), win,
                                  threshold=PLAN["threshold"],
                                  leak=PLAN["leak"],
                                  backend="ref")[0].numpy()


def _events(log, drop=("elapsed_ms",)):
    """Events less their wall-time fields (a stalled refresh's elapsed
    ms, also quoted in its rejection reason)."""
    return [{k: v for k, v in e.items() if k not in drop
             and not str(v).startswith("stalled refresh: ")} for e in log]


def _run_twins(n_req, tmp_path=None, **kw):
    out = {}
    for pkg in ("jax", "port"):
        sd = None if tmp_path is None else str(tmp_path / pkg)
        eng = _engine(pkg, state_dir=sd, **kw)
        if "hook" in kw:
            kw["hook"].engines.append(eng)
        out[pkg] = (eng, eng.run(_requests(pkg, n_req)))
    (jeng, jreqs), (teng, treqs) = out["jax"], out["port"]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert [r.served_version for r in treqs] == \
        [r.served_version for r in jreqs]
    for a, b in zip(treqs, jreqs):
        if a.counts is not None:
            np.testing.assert_array_equal(a.counts, np.asarray(b.counts))
            ver = teng.store.get(a.served_version)
            np.testing.assert_array_equal(a.counts, _oracle(ver.weights, a))
    js, ts = jeng.stats(), teng.stats()
    for k in WALL_KEYS:
        js.pop(k), ts.pop(k)
    assert ts == js
    assert _events(teng.refresh_events) == _events(jeng.refresh_events)
    assert _events(teng.store.events, ("error",)) == \
        _events(jeng.store.events, ("error",))
    assert teng.store.promoted_order == jeng.store.promoted_order
    assert teng.store.demoted == jeng.store.demoted
    assert weight_fingerprint(teng.weights) == \
        weight_fingerprint(np.asarray(jeng.weights))
    if tmp_path is not None:
        def files(d):
            return {str(p.relative_to(d)): p.read_bytes()
                    for p in sorted(d.rglob("*")) if p.is_file()}
        assert files(tmp_path / "port") == files(tmp_path / "jax")
    return jeng, teng, treqs


# --- the store ------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_dir_restores_across_packages(tmp_path, writer):
    """Two promotions persisted by one package; a store over the same
    ``state_dir`` in the other restores the newest complete version
    (same number, fingerprint and probe accuracy), and a rollback re-reads
    the previous one from disk bit-exact."""
    store_cls = JStore if writer == "jax" else VersionedWeightStore
    conv = jnp.asarray if writer == "jax" else (lambda w: w)
    st = store_cls(conv(_bank(0)), state_dir=tmp_path)
    for seed, acc in ((1, 0.5), (2, 0.75)):
        cand = st.stage(conv(_bank(seed)))
        assert st.promote(dataclasses.replace(cand, probe_accuracy=acc))
        st.swap_if_pending()
    other_store = (lambda: VersionedWeightStore(
        _bank(9), state_dir=tmp_path, device="cpu")) if writer == "jax" \
        else (lambda: JStore(jnp.asarray(_bank(9)), state_dir=tmp_path))
    srv = other_store().serving
    assert (srv.version, srv.origin, srv.probe_accuracy) == (2, "restore",
                                                             0.75)
    assert srv.fingerprint == weight_fingerprint(_bank(2))
    # the writer rolls back (re-read from disk, the demoted step
    # deleted); the other package's restart then restores version 1
    tgt = st.rollback("test")
    assert tgt.version == 1 and tgt.probe_accuracy == 0.5
    assert not (tmp_path / "step_2").exists()
    srv = other_store().serving
    assert (srv.version, srv.probe_accuracy) == (1, 0.5)
    np.testing.assert_array_equal(
        weights_to_numpy(srv.weights) if writer == "jax"
        else np.asarray(srv.weights), _bank(1))


def test_save_crash_leaves_a_torn_tmp_and_a_restart_purges_it(tmp_path):
    st = VersionedWeightStore(_bank(0), state_dir=tmp_path, device="cpu")

    def crash(ctx):
        raise RuntimeError(f"died saving {ctx['version']}")
    assert not st.promote(st.stage(_bank(1)), on_save=crash)
    assert (tmp_path / "step_1.tmp").is_dir() and st.save_crashes == 1
    st2 = VersionedWeightStore(_bank(5), state_dir=tmp_path, device="cpu")
    assert st2.serving.version == 0 and not (tmp_path / "step_1.tmp").exists()
    np.testing.assert_array_equal(weights_to_numpy(st2.serving.weights),
                                  _bank(0))
    assert st2.events[0]["event"] == "purged_torn_saves"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rollback_past_a_torn_checkpoint(tmp_path, pkg):
    """A torn rollback target is counted and its droppings purged; the
    in-memory copy serves (both packages alike)."""
    conv = jnp.asarray if pkg == "jax" else (lambda w: w)
    st = (JStore(conv(_bank(0)), state_dir=tmp_path) if pkg == "jax" else
          VersionedWeightStore(_bank(0), state_dir=tmp_path, device="cpu"))
    for seed in (1, 2):
        st.promote(st.stage(conv(_bank(seed))))
        st.swap_if_pending()
    (tmp_path / "step_1" / "weights.proc0.npy").write_bytes(b"torn")
    tgt = st.rollback("test")
    assert tgt.version == 1 and st.rollback_load_failures == 1
    assert st.demoted == {2} and not (tmp_path / "step_1").exists()
    assert [e["event"] for e in st.events][-2:] == ["rollback_target_torn",
                                                    "rollback"]


# --- the refresher ----------------------------------------------------------------

def test_refresher_candidates_and_probe_equal_jax():
    jrf, trf = _refresher("jax"), _refresher("port")
    jw, tw = jnp.asarray(_bank()), as_words(_bank())
    for _ in range(3):
        jc, je = jrf.next_candidate(jw)
        tc, te = trf.next_candidate(tw)
        assert te == je
        np.testing.assert_array_equal(weights_to_numpy(tc), np.asarray(jc))
        assert trf.probe(tc) == jrf.probe(jc)
        jw, tw = jc, tc
    with pytest.raises(ValueError, match="learning plan"):
        SNNWeightRefresher(SNNEnginePlan(w_exp=None), *_quadrant_data(8),
                           n_classes=N_CLASSES, probe_intensities=np.zeros(
                               (1, N_IN), np.uint8), probe_labels=[0],
                           neuron_class=NEURON_CLASS, n_steps=T,
                           device="cpu")


# --- refresh runs through both engines ------------------------------------------------

def test_clean_refresh_run_equals_jax(tmp_path):
    _, teng, treqs = _run_twins(40, tmp_path)
    st = teng.stats()
    assert st["versions_promoted"] >= 1 and st["version_violations"] == 0
    assert len({r.served_version for r in treqs}) > 1
    restored = _engine("port", state_dir=str(tmp_path / "port"),
                       refresher=False, seed_bank=5)
    assert restored.store.serving.version == teng.store.serving.version
    assert restored.store.serving.fingerprint == \
        teng.store.serving.fingerprint


@pytest.mark.parametrize("case", ["corrupt", "stall", "save_crash", "storm"])
def test_refresh_faults_equal_jax(tmp_path, case):
    """Corrupt candidates die at the fingerprint gate, stalled refreshes
    at the timeout, crashes mid-save abort the promotion; a storm of all
    of them with launch faults: the same outcome in both engines."""
    spec, refresh = {
        "corrupt": (dict(seed=3, p_refresh_corrupt=1.0), None),
        "stall": (dict(seed=3, p_refresh_stall=1.0, refresh_stall_ms=5.0),
                  dict(refresh_every=2, probe_size=16, refresh_samples=16,
                       refresh_timeout_ms=1e-3)),
        "save_crash": (dict(seed=3, p_save_crash=1.0), None),
        "storm": (dict(p_launch_error=0.15, p_corrupt=0.15, seed=11,
                       p_refresh_corrupt=0.5, p_refresh_stall=0.25,
                       refresh_stall_ms=1.0, p_save_crash=0.25), None)}[case]
    _, teng, treqs = _run_twins(
        32, tmp_path, spec=spec, refresh=refresh,
        policy=dict(canary_every=3, reprobe_after=4))
    st = teng.stats()
    assert all(r.terminal for r in treqs) and st["refresh_runs"] >= 3
    if case == "corrupt":
        assert st["refresh_corrupt"] == st["refresh_runs"]
        assert st["versions_promoted"] == 0
    elif case == "stall":
        assert st["refresh_timeouts"] == st["refresh_runs"]
    elif case == "save_crash":
        assert st["save_crashes"] >= 1 and st["versions_promoted"] == 0
        assert any(p.suffix == ".tmp" for p in (tmp_path / "port").iterdir())
    else:
        assert st["refresh_corrupt"] == teng.on_launch.refresh_corruptions


class CorruptCanaryAfterPromotion:
    """Once a refreshed version serves, move the canary's counts inside
    their range (the guard cannot see it): the post-promotion rollback."""

    def __init__(self):
        self.engines = []

    def __call__(self, ctx):
        if (ctx.get("kind") == "canary"
                and self.engines[-1]._pinned.origin == "refresh"):
            def corrupt(counts):
                out = np.array(counts)
                out[:, 0] += 1
                return out
            return corrupt
        return None


def test_canary_rollback_equals_jax(tmp_path):
    _, teng, _ = _run_twins(32, tmp_path, hook=CorruptCanaryAfterPromotion(),
                            policy=dict(canary_every=1))
    st = teng.stats()
    assert st["rollbacks"] >= 1 and st["canary_failures"] >= 1
    assert any(e["event"] == "rollback" for e in teng.refresh_events)
    restarted = _engine("jax", state_dir=str(tmp_path / "port"),
                        refresher=False, seed_bank=5)
    np.testing.assert_array_equal(np.asarray(restarted.weights),
                                  weights_to_numpy(teng.weights))


def test_serve_cli_refresh_with_state_dir_matches_jax(tmp_path):
    """``serve --refresh-every 1 --state-dir`` through both launchers:
    the same statuses and refresh report, the oracle check and the
    version audit passing, and the same checkpoint bytes on disk."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"),
               JAX_PLATFORMS="cpu")
    args = ["--arch", "wenquxing-snn", "--refresh-every", "1",
            "--requests", "9", "--refresh-samples", "8", "--probe-size",
            "8"]
    lines = {}
    for pkg, module, extra in (
            ("port", "repro_torch.launch.serve", ["--device", "cpu"]),
            ("jax", "repro.launch.serve", [])):
        proc = subprocess.run(
            [sys.executable, "-m", module, *args, "--state-dir",
             str(tmp_path / pkg), *extra], capture_output=True, text=True,
            env=env, timeout=300, cwd=repo)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        lines[pkg] = [ln for ln in proc.stdout.splitlines()
                      if ln.startswith(("statuses", "oracle-check",
                                        "refresh-gain"))]
    assert lines["port"] == lines["jax"]
    assert "version-audit=ok" in lines["port"][-1]

    def files(d):
        return {str(p.relative_to(d)): p.read_bytes()
                for p in sorted(d.rglob("*")) if p.is_file()}
    assert files(tmp_path / "port") == files(tmp_path / "jax")
