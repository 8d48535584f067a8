"""Marker registration for the harness's own tests (the same marker the
repository's tests register)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; the test skips itself where there is none",
    )
