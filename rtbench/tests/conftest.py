"""The benchmark's own tests: CPU checks of the harness, the reference and
the comparison; the ``cuda`` tests run on a card and skip without one.

    python -m pytest rtbench/tests -q -p no:cacheprovider

This file imports no JAX: the tests hold the harness to importing none.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")
