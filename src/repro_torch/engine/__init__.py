"""repro_torch.engine — the SNN execution plan and its engine.

One frozen :class:`SNNEnginePlan` and one :class:`SNNEngine` (three
verbs) own kernel-path and placement decisions; ``repro_torch.core``'s
network and trainer and ``repro_torch.serving`` are thin layers over
them.  The grid wrappers of :mod:`repro_torch.distributed.snn_mesh` map
to the verbs of an engine whose plan holds the grid:

==========================================  ==========================================
grid wrapper (``snn_mesh.``, ``mesh=m``)    verb of ``SNNEngine(replace(plan, mesh=m))``
==========================================  ==========================================
``sharded_infer_window_batch``              ``infer(w, wins)``
``sharded_infer_window_batch_encode``       ``infer(w, intensities=x, ...)`` (1)
``sharded_fused_snn_window``                ``train(rf, win)``
``sharded_fused_snn_window_encode``         ``train(rf, intensities=x, ...)`` (1)
``sharded_train_window_batch``              ``train_batch(rfs, wins)``
``sharded_train_window_batch_encode``       ``train_batch(rfs, intensities=x, ...)`` (1)
``sharded_train_stream_batch_encode``       ``train_stream_batch(eng, rfs, intensities=x, ...)`` (1)
==========================================  ==========================================

where ``plan = SNNEnginePlan(threshold=..., leak=..., w_exp=...,
gain=..., n_syn=..., ltp_prob=..., kernel_backend=...)`` is built once
(or by :func:`plan_from_config` from an ``SNNTrainConfig``),
``replace`` is ``dataclasses.replace`` and (1) marks a plan with
``encode="kernel"``; ``train_stream_batch`` is this module's stream
driver.  ``mesh_shape=(data, neurons)`` in place of ``mesh=m`` builds
the 2-D grid on the engine's device.  The grid splits batch axes over
"data" and register files over "neurons", and every factorization is
bit-exact with the unsharded path.
"""

from repro_torch.engine.engine import (SNNEngine, SNNOutput, refresh_weights,
                                       reset_between_samples, resolve_device,
                                       train_stream, train_stream_batch)
from repro_torch.engine.plan import SNNEnginePlan, plan_from_config

__all__ = ["SNNEngine", "SNNEnginePlan", "SNNOutput", "plan_from_config",
           "refresh_weights", "reset_between_samples", "resolve_device",
           "train_stream", "train_stream_batch"]
