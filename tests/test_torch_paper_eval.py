"""The paper's evaluation on the port against the same logic on the JAX
package.

Each module of ``repro_torch.bench`` runs here on the CPU (the kernels'
plain versions) at a small size: 40 training and 24 test digits, T 16,
one epoch, at most 20 neurons.  The JAX side is the same script logic
written out with the JAX package's ``ref`` oracles on the counter encode
both packages share: ``repro.core.trainer.train`` on
``WENQUXING_22A_INTENSITY`` with the per-block seeds it derives (handed
to the port), test windows from ``encode_from_counter_batch``,
``network.infer_batch``, ``unpack``, ``count_events`` and ``energy``.
Both packages see the same float32 digits (the JAX preprocess), and
accuracies are compared as counts of correct predictions.  Every
comparison is exact."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wenquxing_snn import WENQUXING_22A_INTENSITY as J_CFG
from repro.core import energy as jenergy
from repro.core import network as jnetwork
from repro.core import trainer as jtrainer
from repro.core.bitpack import unpack as junpack
from repro.core.encoder import (encode_from_counter_batch as jencode_batch,
                                quantize_intensities as jquantize,
                                sample_seeds as jsample_seeds)
from repro.core.preprocess import preprocess_batch as jpreprocess_batch
from repro.data.digits import make_digits
from repro_torch.bench import (common, fig4_energy, fig5_neurons, run,
                               table1_accuracy, table2_resources, wexp_sweep)
from repro_torch.core.bitpack import words_to_numpy

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import table1_accuracy as jtable1  # noqa: E402
from benchmarks import table2_resources as jtable2  # noqa: E402

N_TRAIN, N_TEST, T, N = 40, 24, 16, 20
# the test-set counter bases, after the JAX scripts' keys: key(7) in
# Fig. 4, key(99) elsewhere
FIG4_BASE, TEST_BASE = 7, 99


@functools.cache
def _dataset():
    """The JAX package's preprocess of the procedural digits (seeds 1
    and 2, as ``digits_dataset``), float32[n, 784]."""
    out = []
    for n, seed in ((N_TRAIN, 1), (N_TEST, 2)):
        imgs, labels = make_digits(n, seed=seed)
        x = np.asarray(jpreprocess_batch(
            jnp.asarray(imgs.reshape(-1, 28, 28)), 0.1)).reshape(n, -1)
        out += [x, labels]
    return tuple(out)


def _jcfg(n_neurons=N, w_exp=128):
    return dataclasses.replace(J_CFG, n_neurons=n_neurons, n_steps=T,
                               epochs=1, w_exp=w_exp)


@functools.cache
def _jax_model(n_neurons=N, w_exp=128):
    tr, tr_lab, _, _ = _dataset()
    return jtrainer.train(_jcfg(n_neurons, w_exp), tr, tr_lab)


def _jax_block_seeds(cfg):
    """The per-block LFSR seeds ``repro.core.trainer.train`` derives from
    its default key for ``cfg`` (active mode), in the order it draws
    them."""
    key = jax.random.key(cfg.seed)
    key, _ = jax.random.split(key)        # the host-encode key
    seeds = []
    for _ in range(cfg.n_blocks):
        key, bk = jax.random.split(key)
        seeds.append(jtrainer._regfile_seed(bk))
    return seeds


def _port(mod, **kw):
    return mod.run(dataset=_dataset(), n_steps=T, epochs=1, device="cpu",
                   block_seeds=_jax_block_seeds, **kw)


def _assert_same_model(model, jm):
    np.testing.assert_array_equal(words_to_numpy(model.weights),
                                  np.asarray(jm.weights))
    np.testing.assert_array_equal(model.neuron_class.numpy(),
                                  np.asarray(jm.neuron_class))


def _jax_test_set(base):
    te = _dataset()[2]
    return jquantize(jnp.asarray(te)), jsample_seeds(base, N_TEST)


def _jax_correct(jm, base=TEST_BASE):
    inten, seeds = _jax_test_set(base)
    pred = jtrainer.classify(jm, intensities=inten, seeds=seeds)
    return int((np.asarray(pred) == _dataset()[3]).sum())


def _jax_counts(jm, cfg, base):
    inten, seeds = _jax_test_set(base)
    windows = jencode_batch(seeds, inten, T)
    return windows, np.asarray(jnetwork.infer_batch(jm.weights, windows,
                                                    cfg.lif()))


def test_table1_matches_jax():
    res = _port(table1_accuracy, n_neurons=N)
    jm = _jax_model()
    _assert_same_model(res["model"], jm)
    correct = _jax_correct(jm)
    assert res["correct"] == correct
    assert res["accuracy"] == correct / N_TEST
    assert res["ceiling"] == jtable1.oracle_ceiling(*_dataset())
    assert table1_accuracy.PAPER_ROWS == jtable1.PAPER_ROWS


def test_oracle_ceiling_equals_the_jax_script_on_random_sets():
    rng = np.random.default_rng(0)
    tr, te = rng.random((200, 784), np.float32), rng.random((60, 784),
                                                           np.float32)
    tr_lab, te_lab = rng.integers(0, 10, 200), rng.integers(0, 10, 60)
    for k in (1, 16, 128, 784):
        assert (table1_accuracy.oracle_ceiling(tr, tr_lab, te, te_lab, k)
                == jtable1.oracle_ceiling(tr, tr_lab, te, te_lab, k))


def test_fig4_matches_jax():
    res = _port(fig4_energy, n_neurons=N)
    jm, cfg = _jax_model(), _jcfg()
    _assert_same_model(res["model"], jm)
    windows, counts = _jax_counts(jm, cfg, FIG4_BASE)
    in_spikes = int(junpack(windows.reshape(-1, windows.shape[-1]),
                            784).sum())
    post = int(counts.sum())
    assert (res["in_spikes"], res["post"]) == (in_spikes, post)
    assert in_spikes > 0 and post > 0
    k = jenergy.EnergyConstants()
    want = {}
    for machine in ("fused", "decoupled"):
        ev = jenergy.count_events(cfg.n_neurons, cfg.n_inputs,
                                  cfg.n_steps * N_TEST, in_spikes, post,
                                  machine)
        assert dataclasses.asdict(res["events"][machine]) == \
            dataclasses.asdict(ev)
        want[machine] = jenergy.energy(ev, k, machine)
        assert res["energy"][machine] == want[machine]
    assert res["ratio"] == (want["decoupled"]["total_J"]
                            / want["fused"]["total_J"])


def test_fig5_matches_jax():
    res = _port(fig5_neurons, neuron_counts=(10, 20))
    correct = {}
    for n in (10, 20):
        jm = _jax_model(n)
        _assert_same_model(res["models"][n], jm)
        correct[n] = _jax_correct(jm)
        assert res["correct"][n] == correct[n]
        assert res["accuracy"][n] == correct[n] / N_TEST
    assert res["monotone"] == (correct[10] <= correct[20])


@pytest.mark.parametrize("w_exp", [128, 256, 512])
def test_wexp_sweep_matches_jax(w_exp):
    res = _port(wexp_sweep, n_neurons=N, w_exps=(w_exp,))[w_exp]
    jm, cfg = _jax_model(N, w_exp), _jcfg(N, w_exp)
    _assert_same_model(res["model"], jm)
    _, counts = _jax_counts(jm, cfg, TEST_BASE)
    winner = counts.argmax(1)
    pred = np.asarray(jm.neuron_class)[winner]
    assert res["correct"] == int((pred == _dataset()[3]).sum())
    assert res["dead"] == cfg.n_neurons - len(set(winner.tolist()))
    assert res["mean_on"] == float(np.mean(np.asarray(
        junpack(jm.weights, 784).sum(axis=1))))


def test_table2_matches_jax(capsys):
    got = table2_resources.run()
    want = jtable2.run()
    assert got["ours_bytes"] == want["ours_bytes"]
    assert got["odin_bytes"] == want["odin_bytes"]
    assert got["ours"] == jenergy.footprint(40, 784)
    assert table2_resources.PAPER == jtable2.PAPER
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("table2/")]
    assert [r.split(",")[0] for r in rows[:4]] == \
        [r.split(",")[0] for r in rows[4:]]


def test_digits_dataset_matches_the_jax_preprocess():
    tr, tr_lab, te, te_lab = common.digits_dataset(N_TRAIN, N_TEST)
    jtr, jtr_lab, jte, jte_lab = jcommon.digits_dataset(N_TRAIN, N_TEST)
    np.testing.assert_array_equal(tr_lab, jtr_lab)
    np.testing.assert_array_equal(te_lab, jte_lab)
    assert tr.dtype == np.float32 and tr.shape == (N_TRAIN, 784)
    np.testing.assert_allclose(tr, jtr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(te, jte, rtol=0, atol=1e-5)


def test_emit_and_time_fn(monkeypatch, capsys):
    monkeypatch.setattr(common, "RECORDS", [])
    monkeypatch.setattr(jcommon, "RECORDS", [])
    for mod in (common, jcommon):
        mod.emit("a/analytic", None, "modeled=4.72x;note=text;E=1e-3J")
        mod.emit("a/timed", 12.345, "CA=0.5000;dead=3")
    assert common.RECORDS == jcommon.RECORDS == [
        {"name": "a/analytic", "analytic": True, "modeled": 4.72,
         "note": "text", "E": "1e-3J"},
        {"name": "a/timed", "us_per_call": 12.345, "CA": 0.5, "dead": 3.0}]
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] == [
        "a/analytic,,modeled=4.72x;note=text;E=1e-3J;analytic=true",
        "a/timed,12.35,CA=0.5000;dead=3"]
    calls = []
    us = common.time_fn(calls.append, 1, reps=3, warmup=2, device="cpu")
    assert calls == [1] * 5 and us >= 0.0


def test_run_refuses_unknown_modules_and_the_jax_rows_file(capsys):
    assert run.main(["no_such_module", "--device", "cpu"]) == 2
    assert run.main(["--json=BENCH_kernels.json", "table2_resources"]) == 2
    assert run.main(["--json=sub/BENCH_kernels.json"]) == 2
    assert not (Path.cwd() / "sub").exists()


def test_run_defaults_to_the_card(capsys):
    """Without ``--device`` ``run.main`` asks for the card, and without one
    it stops before any module runs."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["table2_resources"])
    assert "table2/" not in capsys.readouterr().out


def test_run_cli_on_the_cpu(tmp_path):
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--device", "cpu",
         "table2_resources", "fig4_energy", "--n-train", "24", "--n-test",
         "12", "--n-steps", "8", "--epochs", "1", "--neurons", "10",
         f"--json={out}"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = json.loads(out.read_text())
    # the file starts with the device row, which names the device
    assert next(iter(rows)) == "meta/device"
    assert rows.pop("meta/device")["device"] == "cpu"
    assert set(rows) == {
        "fig4/fused", "fig4/decoupled", "fig4/ratio-decoupled-over-fused",
        "table2/this-work", "table2/odin-crossbar", "table2/paper-ODIN",
        "table2/paper-Wenquxing22A"}
    assert all(r["analytic"] for r in rows.values())
    assert rows["fig4/ratio-decoupled-over-fused"]["paper"] == 5.13
    assert rows["table2/this-work"]["state_bytes"] == 8260
    # module order follows benchmarks/run.py, not the command line
    names = [line.split(",")[0] for line in lines if "/" in line]
    assert names.index("fig4/fused") < names.index("table2/this-work")
