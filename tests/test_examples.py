"""The examples are executable documentation — run each one end-to-end
at small sizes (they self-validate against numpy twins and raise on
mismatch).
"""

import os
import runpy


_EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir,
                         "examples")


def _run(name, monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runpy.run_path(os.path.join(_EXAMPLES, name), run_name="__main__")


def test_laplace7pt(monkeypatch):
    _run("laplace7pt.py", monkeypatch, BRICK_EXAMPLE_N="16")


def test_varcoeff_diffusion(monkeypatch):
    _run("varcoeff_diffusion.py", monkeypatch, BRICK_EXAMPLE_N="16")


def test_gray_scott(monkeypatch):
    _run("gray_scott.py", monkeypatch, BRICK_EXAMPLE_N="16",
         BRICK_EXAMPLE_STEPS="3")


def test_distributed_weak(monkeypatch):
    # conftest provides 8 virtual CPU devices, so the example runs its
    # mesh inline (no re-exec)
    _run("distributed_weak.py", monkeypatch,
         BRICK_EXAMPLE_DIMS="32,32,32")


def test_adjoint_assimilation(monkeypatch):
    _run("adjoint_assimilation.py", monkeypatch, BRICK_EXAMPLE_N="16",
         BRICK_EXAMPLE_STEPS="40")


def test_coefficient_inversion(monkeypatch):
    _run("coefficient_inversion.py", monkeypatch, BRICK_EXAMPLE_N="16",
         BRICK_EXAMPLE_STEPS="60")


def test_multigrid_poisson(monkeypatch):
    _run("multigrid_poisson.py", monkeypatch, BRICK_EXAMPLE_N="16",
         BRICK_EXAMPLE_STEPS="5")


def test_wave_2d(monkeypatch):
    _run("wave_2d.py", monkeypatch, BRICK_EXAMPLE_N="16",
         BRICK_EXAMPLE_STEPS="2")
