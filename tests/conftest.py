"""Test configuration.

Tests run on the default JAX platform (CPU under ``JAX_PLATFORMS=cpu``,
the GPU on the card).  Multi-device sharding is exercised separately in
tests/test_parallel.py, which re-launches itself in a subprocess with a
virtual 8-device CPU mesh (``xla_force_host_platform_device_count``) —
the SURVEY.md §4 pattern — because the platform must be chosen before
JAX initializes.  Tests marked ``gpu`` take the ``gpu`` fixture, which
skips them unless JAX's default backend is a GPU; the decision is made
when the fixture runs, never at import or collection time.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import pytest  # noqa: E402

CORPUS_DIR = pathlib.Path("/root/reference/resources")
CORPUS_FILES = [
    "welcome.zst",
    "romeo.txt.zst",
    "romeo3.txt.zst",
    "skippables.zst",
    "moby-dick.txt.zst",
]


@pytest.fixture(scope="session")
def corpus():
    """The reference's bundled .zst corpus as {name: bytes}."""
    if not CORPUS_DIR.is_dir():
        pytest.skip("reference corpus not available")
    return {name: (CORPUS_DIR / name).read_bytes() for name in CORPUS_FILES}


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on the card)")
