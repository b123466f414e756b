"""The single-controller pipeline schedule against the JAX package's
``pipelined_apply`` (``shard_map`` over 4 forced host devices, in a
subprocess, as ``tests/test_pipeline.py`` runs it) and against the
stages applied in sequence.

Inputs from numpy (seed 0); float32.  Against JAX within 1e-5 (the two
frameworks' tanh and matmul round differently in the last bits);
against sequential application, exact (the same ops on the same data).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import pipeline_schedule, pipelined_apply

ROOT = Path(__file__).resolve().parents[1]
S, M, B, D = 4, 6, 2, 16


def _inputs(m: int = M):
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(m, B, D)).astype(np.float32)
    return ws, x


def stage_fn(w, x):
    return torch.tanh(x @ w)


def _sequential(ws, x):
    y = torch.from_numpy(x)
    for s in range(S):
        y = torch.tanh(y @ torch.from_numpy(ws[s]))
    return y


def test_matches_the_jax_package(tmp_path):
    ws, x = _inputs()
    np.save(tmp_path / "ws.npy", ws)
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import sys
        sys.path.insert(0, "src")
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline import pipelined_apply
        mesh = jax.make_mesh(({S},), ("stage",),
                             axis_types=(jax.sharding.AxisType.Auto,))
        ws = jnp.asarray(np.load("{tmp_path}/ws.npy"))
        x = jnp.asarray(np.load("{tmp_path}/x.npy"))
        out = pipelined_apply(mesh, lambda w, x: jnp.tanh(x @ w), ws, x,
                              axis_name="stage")
        np.save("{tmp_path}/out.npy", np.asarray(out))
        print("JAX_PIPELINE_OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert "JAX_PIPELINE_OK" in r.stdout, r.stdout + r.stderr
    got = pipelined_apply(["cpu"] * S, stage_fn, torch.from_numpy(ws),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.load(tmp_path / "out.npy"),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [M, 1, 2])
def test_matches_sequential_application(m):
    """M > S, M = 1 and M < S: every microbatch through every stage."""
    ws, x = _inputs(m)
    got = pipelined_apply(["cpu"] * S, stage_fn, torch.from_numpy(ws),
                          torch.from_numpy(x))
    assert got.shape == (m, B, D)
    assert torch.equal(got, _sequential(ws, x))


def test_schedule_runs_each_stage_once_per_microbatch():
    calls = []

    def fn(s, x):
        calls.append((s, int(x[0])))
        return x + 1

    run = pipeline_schedule(fn, 3, 4)
    out = run([torch.device("cpu")] * 3, [0, 1, 2],
              torch.arange(4.0)[:, None])
    assert out[:, 0].tolist() == [3.0, 4.0, 5.0, 6.0]
    assert sorted(calls) == sorted((s, m + s) for s in range(3)
                                   for m in range(4))
    # tick order: stage s starts microbatch m at tick m + s
    assert calls[:3] == [(0, 0), (0, 1), (1, 1)]
    with pytest.raises(ValueError):
        run([torch.device("cpu")] * 2, [0, 1, 2], torch.zeros(4, 1))
