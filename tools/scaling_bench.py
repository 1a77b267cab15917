#!/usr/bin/env python3
"""Multi-process kernel-phase scaling on the CPU backend.

Runs the multihost engine at nproc = 1 and nproc = 2 on the CPU
backend over the SAME corpus and reports the kernel-phase wall time
and scaling efficiency  eff = t(1) / (2 * t(2)).  Prints one JSON line.
It checks the multi-process plumbing; CPU times say nothing about a
GPU.

Usage: python tools/scaling_bench.py [corpus_MB]
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

_SUBPROC = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
import jax
from zstd_tpu.parallel import multihost
nproc = {nproc}
if nproc > 1:
    # Must precede ANY backend-initialising jax call (jax.devices etc.).
    multihost.initialize("localhost:{port}", nproc, int(sys.argv[1]))
print("DEVICES", jax.devices(), file=sys.stderr, flush=True)
from zstd_tpu.testing.corpus import build_corpus
from zstd_tpu.testing import libzstd
raw = build_corpus({mb})
chunk = 32 << 10    # small frames keep the CPU backend's scan compiles
                    # at the test suite's shapes
comp = b"".join(
    libzstd.compress(raw[i : i + chunk], 3, checksum=True)
    for i in range(0, len(raw), chunk)
)
eng = multihost.MultihostEngine()
t0 = time.perf_counter()
out = eng.decompress(comp)          # warm-up + compile
print("WARMUP_S", round(time.perf_counter() - t0, 1), file=sys.stderr, flush=True)
assert out == raw
t = []
for _ in range(2):
    eng.decompress(comp)
    t.append(eng.stats.wall_s["kernels"])
print(json.dumps({{"pid": jax.process_index(),
                  "kernels_s": min(t),
                  "total_s": eng.stats.wall_s["total"],
                  "kernel_calls": eng.stats.kernel_calls}}), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(nproc: int, mb: float) -> list[dict]:
    env = dict(os.environ)
    # Mirror tests/test_multihost.py: the 4-virtual-device CPU config
    # whose executables already sit in the persistent compile cache
    # from the test suite.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    script = _SUBPROC.format(repo=REPO, port=_free_port(), nproc=nproc, mb=mb)
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
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=3500)
        assert p.returncode == 0, f"process failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results.append(json.loads(line))
    return results


def main() -> None:
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 0.75
    r1 = run(1, mb)
    r2 = run(2, mb)
    t1 = r1[0]["kernels_s"]
    t2 = max(r["kernels_s"] for r in r2)  # job finishes with the slowest
    print(
        json.dumps(
            {
                "metric": "multihost kernel-phase scaling (CPU backend)",
                "corpus_MB": mb,
                "kernels_s_1proc": round(t1, 3),
                "kernels_s_2proc": round(t2, 3),
                "speedup": round(t1 / t2, 3),
                "efficiency": round(t1 / (2 * t2), 3),
                "per_proc_2": [round(r["kernels_s"], 3) for r in r2],
            }
        )
    )


if __name__ == "__main__":
    main()
