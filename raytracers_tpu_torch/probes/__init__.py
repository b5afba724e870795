"""Probes: small kernels that measure what the card offers the renderer's
kernels.  ``microbench`` holds M1-M4, the counterparts of the TPU probes of
``tools/microbench_tpu.py``; ``microbench_v5`` M5 and M6, those of
``tools/microbench_v5.py``; ``microbench_mxuquad`` M7, that of
``tools/microbench_mxuquad.py``."""
