"""The port's two LM training CLIs on the CPU: ``launch/train.py``
(``--reduced``, one and two microbatches, the enc-dec and vision
configs) and ``launch/train_lm.py`` (``--preset tiny``, with and without
stochastic rounding), a few steps each."""

import numpy as np
import pytest

from repro_torch.launch import train as train_launch
from repro_torch.launch import train_lm


@pytest.mark.parametrize("arch,accum", [("gemma3-1b", 1),
                                        ("whisper-small", 2),
                                        ("internvl2-26b", 1)])
def test_train_cli_runs_on_the_cpu(arch, accum, tmp_path, capsys):
    loop = train_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "3", "--seq", "32", "--batch", "2",
                              "--accum", str(accum), "--ckpt-dir",
                              str(tmp_path)])
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in loop.metrics_log)
    assert "loss" in capsys.readouterr().out


@pytest.mark.parametrize("sr", [False, True])
def test_train_lm_cli_runs_on_the_cpu(sr, tmp_path, capsys):
    argv = ["--preset", "tiny", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--seq", "64", "--ckpt-dir", str(tmp_path)]
    loop = train_lm.main(argv + (["--stochastic-rounding"] if sr else []))
    losses = [m["loss"] for m in loop.metrics_log]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "loss:" in capsys.readouterr().out
