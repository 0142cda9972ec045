"""chip_smoke.py refuses to report a result without an accelerator."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fails_without_gpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a gpu device" in out.stderr
