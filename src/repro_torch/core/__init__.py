"""repro_torch.core — Wenquxing 22A's contribution on PyTorch.

Layers (bottom-up), as in the JAX package's ``repro.core``:
  lfsr / bitpack          bit-exact PRNG + 1-bit synapse packing
  lif / stdp              streamlined LIF (C2), binary stochastic STDP (C3)
  rvsnn                   RV-SNN V1.0 instruction semantics (C1)
  encoder / preprocess    Poisson rate coding, deskew + soft threshold
  network / trainer       window execution, supervised STDP + active
                          learning (C4)
  energy                  event-driven energy/footprint model (Fig.4/Tab.2)

The leaf modules are imported here.  ``rvsnn``, ``network`` and
``trainer`` reach the kernel wrappers and the engine, which import these
leaves back, so their names load on first use: ``import
repro_torch.engine`` (or ``repro_torch.kernels.ref``) in a fresh
interpreter runs this file before that package has any name to give.
"""

import importlib

from repro_torch.core.bitpack import n_words, pack, popcount, tail_mask, unpack
from repro_torch.core.encoder import (encode_from_counter,
                                      encode_from_counter_batch,
                                      poisson_encode, poisson_encode_batch,
                                      quantize_intensities, spike_rate)
from repro_torch.core.lif import LIFParams, lif_params, lif_reset, lif_step
from repro_torch.core.stdp import (STDPParams, init_weights,
                                   ltd_prob_from_wexp, stdp_params,
                                   stdp_update)
from repro_torch.core.preprocess import (deskew, preprocess, preprocess_batch,
                                         soft_threshold)
from repro_torch.core import energy  # noqa: F401

_LAZY = {**dict.fromkeys(("SnnRegFile", "snn_ls", "snn_nu", "snn_regfile",
                          "snn_sp", "snn_step", "snn_su"), "rvsnn"),
         **dict.fromkeys(("SNNOutput", "infer_batch", "run_sample",
                          "train_stream"), "network"),
         **dict.fromkeys(("SNNModel", "SNNTrainConfig", "accuracy",
                          "classify", "train"), "trainer")}

__all__ = sorted({k for k in dir() if not k.startswith("_")
                  and k != "importlib"} | set(_LAZY) | set(_LAZY.values()))


def __getattr__(name: str):
    if name in _LAZY.values():
        return importlib.import_module(f"{__name__}.{name}")
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
