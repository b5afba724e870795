"""Probes: small kernels that measure what the card offers the renderer's
kernels.  ``microbench`` holds M1-M4, the counterparts of the TPU probes of
``tools/microbench_tpu.py``."""
