import os

# Tests run on the CPU backend with a virtual 8-device mesh unless the
# caller picks a platform: `python chip_smoke.py` runs the `gpu`-marked
# tests with JAX_PLATFORMS=cuda.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import importlib.util  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import pytest  # noqa: E402

REFERENCE_PATH = "/root/reference/MAPLEv0.7.5.4.py"
EXAMPLE_ALIGNMENT = "/root/reference/example_files/MAPLE_alignment_example.txt"

HERE = os.path.dirname(os.path.abspath(__file__))
# In-repo inputs: an 80-sample subset of the reference's example alignment
# (its goldens were made by the reference) and the real B.1.429 3k subset.
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
B3000 = os.path.join(HERE, "data_b1429_3000.maple.gz")

_ref_module_cache = {}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (run on the card by "
                   "`python chip_smoke.py`; skipped elsewhere)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, never at
    import, so every xdist worker collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()!r})")


def load_reference_module(extra_argv=()):
    """Import the reference implementation as a module (argv patched so its
    top-level argparse sees a benign command line). Used purely as a test
    oracle for differential testing; skipped when the reference isn't
    mounted."""
    key = tuple(extra_argv)
    if key in _ref_module_cache:
        return _ref_module_cache[key]
    if not os.path.isfile(REFERENCE_PATH):
        pytest.skip("reference implementation not available")
    old_argv = sys.argv
    sys.argv = ["maple", "--input", EXAMPLE_ALIGNMENT,
                "--output", "/tmp/_maple_ref_oracle", "--overwrite",
                *extra_argv]
    try:
        spec = importlib.util.spec_from_file_location(
            f"reference_maple_{len(_ref_module_cache)}", REFERENCE_PATH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = old_argv
    _ref_module_cache[key] = mod
    return mod


@pytest.fixture(scope="session")
def refmod():
    return load_reference_module()


@pytest.fixture(scope="session")
def refgenome():
    """Stand-in for ``refmod`` where only the reference genome is needed
    (the oracle is the native or Python host kernel): ``.ref`` is the
    sub80 alignment's reference sequence."""
    from maple_jax.io.maple_format import read_maple_alignment
    ref, _ = read_maple_alignment(SUB80)
    return SimpleNamespace(ref=ref)
