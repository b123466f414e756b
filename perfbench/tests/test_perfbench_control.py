"""The control comes out not correct, and a sound run correct, through
the harness's own comparison.

On the CPU, at the tiny fixture's size: the reference computed in
float8 put in the program's place (its tokens and its logits at the
positions the run kept) reads ``correct`` false where the served bf16
program reads true.  On a card (``gpu``), at the real cell's size, one
seed and the cell's own window (``control.py`` reads more): the same.
"""

import json
from pathlib import Path

import pytest
import torch

from perfbench import harness, traffic
from perfbench.capture import Capture
from perfbench.control import readings

ROOT = Path(__file__).resolve().parents[2]


def _readings(root, cell_name, seed, seconds, device):
    cell = harness.find(root, cell_name)
    params = cell.traffic
    tr = traffic.Traffic(params, seed, cell.dims.vocab, seconds)
    model = harness.build_model(cell, seed, device)
    harness.warm_up(model, params, tr)
    eng = harness.engine_for(model, params)
    capture = Capture(seed, cell.check["keep_every"])
    capture.install(eng)
    log = harness.drive(eng, tr, params, seconds, capture=capture)
    capture.uninstall()
    del eng, model
    return readings(cell, seed, log, capture, device), cell.check["limits"]


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_control_fails_where_the_program_passes_cpu(tiny_root, seed):
    got, limits = _readings(tiny_root, "tiny-gen", seed, 3.0, "cpu")
    assert got["program"]["correct"], got
    assert not got["control"]["correct"], got
    assert got["control"]["logit_err_mean"] > \
        limits["logit_err_mean"]["max"]
    assert got["program"]["logits_compared"] == \
        got["control"]["logits_compared"] >= 4


@pytest.mark.gpu
def test_control_fails_at_the_cell_size(card):
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    got, _ = _readings(ROOT, "mixtral-chat", 2**31 + 99,
                       float(doc["run_seconds"]), card)
    print(json.dumps(got))
    assert got["program"]["correct"] and not got["control"]["correct"]
    torch.cuda.empty_cache()
