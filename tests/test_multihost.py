"""Multi-process distributed decode tests (SURVEY.md §2.3).

Launches a real 2-process jax.distributed job (CPU backend, 4 virtual
devices per process) in subprocesses; both processes must produce the
full, bit-exact output via balanced lane bins + ordered all-gather
exchange.
"""

import os
import socket
import subprocess
import sys

import pytest

from zstd_tpu.testing import libzstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not libzstd.available(), reason="libzstd not available"
)

_SUBPROC = r"""
import hashlib, sys
sys.path.insert(0, {repo!r})
import jax
from zstd_tpu.parallel import multihost
multihost.initialize("localhost:{port}", {nproc}, int(sys.argv[1]))
assert jax.process_count() == {nproc}, jax.process_count()

from zstd_tpu.runtime.oracle import decompress as oracle
payload = (b"multihost decode payload %d " * 1500) % tuple(range(1500))
import ctypes, pathlib
from zstd_tpu.testing import libzstd
data = libzstd.compress(payload, 6, checksum=True)

eng = multihost.MultihostEngine()
out = eng.decompress(data)
assert out == payload, "multihost output mismatch"
assert eng.stats.kernel_calls > 0, "process ran no kernels"
assert eng.stats.fallback_frames == 0, "fell back to oracle"
print(f"MH_OK p{{jax.process_index()}} kc={{eng.stats.kernel_calls}} "
      f"sha={{hashlib.sha256(out).hexdigest()[:16]}}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_decode():
    nproc = 2
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    script = _SUBPROC.format(repo=REPO, port=_free_port(), nproc=nproc)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outputs.append(out)
        assert p.returncode == 0, f"process failed:\n{out}"
    hashes = set()
    for out in outputs:
        lines = [ln for ln in out.splitlines() if ln.startswith("MH_OK")]
        assert lines, f"no MH_OK marker:\n{out}"
        hashes.add(lines[0].split("sha=")[1])
    assert len(hashes) == 1, f"processes disagree: {outputs}"
