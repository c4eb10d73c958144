"""Build hook: compile the native layout planner into the wheel.

The reference installs its C++ library and proves an out-of-tree
consumer builds against it (ref: examples/external/CMakeLists.txt,
examples/external/main.cpp).  The rebuild's native piece is the
ctypes layout planner (csrc/); at wheel-build time we compile it into
``brickjax/_native/`` so installed packages keep the fast path.
If no toolchain is available the build silently skips — the runtime
falls back to the numpy planner (core/native.py returns None).
"""

import pathlib
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class build_py_with_native(build_py):
    def run(self):
        super().run()
        root = pathlib.Path(__file__).parent.resolve()
        csrc = root / "csrc"
        so = csrc / "libbrickplanner.so"
        if not so.exists():
            try:
                subprocess.run(["make", "-C", str(csrc)], check=True,
                               capture_output=True, timeout=300)
            except Exception:
                return
        if so.exists():
            dest = pathlib.Path(self.build_lib) / "brickjax" / "_native"
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copy2(so, dest / so.name)


setup(cmdclass={"build_py": build_py_with_native})
