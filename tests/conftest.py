def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with a reason elsewhere "
        "(chip_smoke.py runs the same checks on the card)")
