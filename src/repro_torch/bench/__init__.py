"""repro_torch.bench — the benchmark harness of the port.

One module per script of the JAX package's ``benchmarks/`` (same file
names): the paper's evaluation (``table1_accuracy``, ``fig5_neurons``,
``wexp_sweep``, ``fig4_energy``, ``table2_resources``), the kernel rows
(``kernels_bench``), the load rows (``loadgen_bench``), their
``common``, ``run``, which runs them and gates them against a committed
baseline (``python -m repro_torch.bench.run``), and ``plot_history``,
which renders the archived rows.
"""
