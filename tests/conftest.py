"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; the test skips itself where there is none",
    )
