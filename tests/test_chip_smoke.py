"""``chip_smoke.py`` must refuse to report a result without a GPU:
non-zero exit and no JSON result line, both on the CPU backend and
when the script stands alone, away from the package."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env,
    )


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            continue
    return True


def test_chip_smoke_fails_without_gpu():
    res = _run(REPO / "chip_smoke.py", REPO)
    assert res.returncode != 0, res.stdout
    assert "no GPU" in res.stdout, res.stdout + res.stderr
    assert _no_result(res.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", script)
    res = _run(script, tmp_path)
    assert res.returncode != 0, res.stdout
    assert _no_result(res.stdout)
