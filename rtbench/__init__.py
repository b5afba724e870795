"""The benchmark of the PyTorch and CUDA port (``raytracers_tpu_torch``).

``python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell; ``README.md`` says how to add a
configuration, a traffic mix, a cell or a metric.
"""
