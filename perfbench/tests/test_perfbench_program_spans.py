"""The readers of the port's own spans and stamps: ``queue_wait_p95_ms``
(the requests' ``t_submit`` / ``t_admit``), ``decode_attn_ms`` and
``decode_launch_ms`` (``repro_torch.runtime.tracing``'s ``attn/decode``
and ``model/decode`` spans).

On the CPU, a traced tiny run reads the queue's wait and the decode
step's host time, and no device time (no events on the CPU); where the
program has no spans or stamps, as before they existed, each reader
reads nothing and raises nothing.  On a card (``gpu``), at the chat
cell's size and one seed, decode attention's device time is a part of
the decode step's.
"""

import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**32 + 17
NEW = ("queue_wait_p95_ms", "decode_attn_ms", "decode_launch_ms")


def _with_new_metrics(root: Path) -> None:
    """Append the three entries, as the repo's BENCHMARK.json has them,
    to the tiny fixture's, for its two cells."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    ours = {m["name"]: m for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name in NEW:
        doc["per_layer"].append(dict(ours[name],
                                     workloads=["tiny-chat", "tiny-gen"]))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))


@pytest.mark.parametrize("cell", ["tiny-chat", "tiny-gen"])
def test_a_traced_tiny_run_reads_the_wait_and_the_launch(tiny_root, cell):
    _with_new_metrics(tiny_root)
    torch.manual_seed(0)
    r = harness.run(tiny_root, cell, SEED, 2.0, True, "cpu",
                    time.perf_counter(), say=lambda *_: None)
    got = r["metrics"]
    assert r["correct"], r["checks"]
    assert got["queue_wait_p95_ms"]["value"] >= 0
    assert got["queue_wait_p95_ms"]["unit"] == "ms"
    assert "decode_attn_ms" not in got          # no CUDA events on the CPU
    if cell == "tiny-gen":                      # decodes all through
        assert got["decode_launch_ms"]["value"] > 0


def test_readers_read_nothing_where_the_program_has_no_spans(monkeypatch):
    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    monkeypatch.delattr(repro_torch.runtime, "tracing", raising=False)
    req = types.SimpleNamespace(rid=0, output=[1])    # no stamps
    flight = types.SimpleNamespace(req=req, t_due=0.5, times=[0.6])
    log = types.SimpleNamespace(t0=0.0, t_end=2.0, seconds=1.0,
                                flights=[flight])
    run = harness.Run(log, None, {}, 0.0)
    for name in NEW:
        assert harness.reader(ROOT, name)(run) is None, name


@pytest.mark.gpu
def test_decode_attention_is_a_part_of_the_step_at_the_chat_size(card):
    r = harness.run(ROOT, "mixtral-chat", 2**31 + 77, 16.0, True, card,
                    time.perf_counter(), say=lambda *_: None)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    print(json.dumps(got))
    assert 0 < got["decode_attn_ms"] < got["decode_step_ms"]
    assert 0 < got["decode_launch_ms"] and got["queue_wait_p95_ms"] >= 0
    torch.cuda.empty_cache()
