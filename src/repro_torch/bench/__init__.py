"""repro_torch.bench — the paper's evaluation on the port.

One module per script of the JAX package's ``benchmarks/`` (same file
names): ``table1_accuracy``, ``fig5_neurons``, ``wexp_sweep``,
``fig4_energy``, ``table2_resources``, their ``common`` and ``run``, which
runs them (``python -m repro_torch.bench.run``).
"""
