"""Multi-device sharded decode tests.

Runs the full sharded pipeline on a virtual 8-device CPU mesh in a
subprocess (the platform must be fixed before JAX initializes, and the
subprocess must not open a GPU the main process may hold).  Also unit-tests the host-side
scheduling pieces in-process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from zstd_tpu.parallel.dist import shard_lanes_balanced

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shard_lanes_balanced():
    costs = np.array([100, 1, 1, 1, 50, 49, 2, 2])
    shards = shard_lanes_balanced(costs, 2)
    assert sorted(np.concatenate(shards).tolist()) == list(range(8))
    loads = [costs[s].sum() for s in shards]
    assert abs(loads[0] - loads[1]) <= 2


def test_shard_lanes_more_shards_than_lanes():
    shards = shard_lanes_balanced(np.array([5]), 4)
    assert sum(len(s) for s in shards) == 1


_SUBPROC = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
from zstd_tpu.parallel.dist import sharded_decompress
from zstd_tpu.parallel.mesh import make_mesh
from zstd_tpu.runtime.oracle import decompress as oracle
from zstd_tpu.testing import libzstd

assert len(jax.devices()) == 8, jax.devices()
payload = (b"sharded decode payload %d " * 400) % tuple(range(400))
data = libzstd.compress(payload, 6, checksum=True)
mesh = make_mesh(8)
out = sharded_decompress(data, mesh)
assert out == payload == oracle(data)
print("SHARDED_OK", len(out))
"""


@pytest.mark.slow
def test_sharded_decode_8_virtual_devices():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    res = subprocess.run(
        [sys.executable, "-c", _SUBPROC.format(repo=REPO)],
        capture_output=True,
        text=True,
        timeout=900,
        env=env,
        cwd=REPO,
    )
    assert "SHARDED_OK" in res.stdout, res.stdout + res.stderr
