"""tools/bench_multichip.py dryrun: the one-command multi-device
exchange harness runs on virtual CPU devices for CI and emits the
reference's phase taxonomy (ref: brick-mpi.h:758-793).
"""

import json
import pathlib
import subprocess
import sys


TOOL = str(pathlib.Path(__file__).resolve().parent.parent / "tools"
           / "bench_multichip.py")


def _run(extra):
    r = subprocess.run(
        [sys.executable, TOOL, "--cpu", "8", "--iters", "3",
         "--st-iter", "2", "--json"] + extra,
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dryrun_shift_form():
    out = _run(["--mesh", "4,2,1"])
    assert out["devices"] == 8
    assert out["backend"] == "cpu"
    assert set(out["phases"]) >= {"calltime", "calctime"}
    for k in ("per_iter_ms", "exchange_share", "exchange_ms",
              "gstencil_s", "honest_spread", "gate"):
        assert k in out, k
    assert "fused_per_iter_ms" not in out
    assert out["gate"]["target_exchange_share"] == 0.10
