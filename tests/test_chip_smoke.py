"""chip_smoke.py refuses to report a result without a GPU: on the CPU it
exits non-zero and prints no `ok` line, both from the checkout and from
a directory that holds the script alone."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_no_gpu_no_result(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
