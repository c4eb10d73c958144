"""Runnable driver analogs of the reference's test executables
(ref: single/, weak/, strong/ described in docs/testcases.md):

  python -m brickjax.drivers.single   # single-{cpu,cuda} analog
  python -m brickjax.drivers.weak     # weak-* analog
  python -m brickjax.drivers.strong   # strong-* analog

Each validates against the dense-array twin and prints the reference's
metrics (GStencil/s, exchange GB/s, phase statistics).
"""
