"""Installed-package smoke: build + install the wheel, drive from outside.

The reference proves an out-of-tree consumer can build against the
installed library (ref: examples/external/main.cpp,
examples/external/CMakeLists.txt).  The analog here: ``pip install`` the
repo into a scratch target dir, then run a 7pt Problem from a subprocess
whose import path contains ONLY the installed copy (cwd=/tmp, PYTHONPATH
pinned) and compare against the dense twin.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

DRIVE = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import brickjax, pathlib, sys

pkg = pathlib.Path(brickjax.__file__).resolve()
target = pathlib.Path(sys.argv[1]).resolve()
assert target in pkg.parents, f"imported {pkg}, not the installed copy"

from brickjax.api import Problem
from brickjax.codegen import dense_apply
from brickjax.core import compare_arrays, random_array
from brickjax.stencils import stencil_by_name

g = random_array((16, 16, 32), np.float32, 4)
p = Problem(dims=(16, 16, 32), stencil="mpi7pt", bdims=(4, 4, 8),
            backend="jnp")
p.init(array=g).step(2)
sd = stencil_by_name("mpi7pt")[0]
lo, hi = sd.radius()
w = g
for _ in range(2):
    wp = np.pad(w, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
    w = dense_apply(sd, {next(iter(sd.inputs)): wp}, p.params, xp=np)
assert compare_arrays(p.result(), w, 1e-4)
print("INSTALLED_OK")
"""


def test_install_and_drive_out_of_tree(tmp_path):
    target = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-build-isolation",
         "--no-deps", "--no-index", "--quiet", "--target", str(target),
         str(REPO)],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"pip install unavailable here: {r.stderr[-500:]}")
    drive = tmp_path / "drive.py"
    drive.write_text(DRIVE)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(target)  # installed copy only, no repo
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(drive), str(target)],
                       capture_output=True, text=True, timeout=600,
                       cwd="/tmp", env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "INSTALLED_OK" in r.stdout
