# NOTE: deliberately does NOT set xla_force_host_platform_device_count —
# smoke tests and benches must see 1 device; multi-device tests run in
# subprocesses (tests/helpers.py).
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: multi-device subprocess tests")
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")
