"""pytest settings of the benchmark's tests: the ``card`` marker of tests
that need an NVIDIA card (each decides in a fixture and skips here)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")
