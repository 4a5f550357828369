def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper (sm_90) card; skips "
        "elsewhere (run on the card: python -m pytest -m cuda tests)")
