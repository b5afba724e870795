"""Examples of the port, run as ``python -m raytracers_tpu_torch.examples.<name>``
(on the card; ``--cpu`` on the host)."""
