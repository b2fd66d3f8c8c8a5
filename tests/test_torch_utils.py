"""The port's utils (timers, profiling) against the JAX package's,
modelled on tests/test_watchdog.py and tests/test_profiling.py, and the
import rule: no module of the port, nor chip_smoke.py, imports jax or the
JAX package.

The watchdog's only action is os._exit, which ends the interpreter, so
every firing test runs in a subprocess."""

import glob
import os
import subprocess
import sys

import pytest
import torch

from navierstokes3d_tpu.utils import timers as jtimers
from navierstokes3d_tpu_torch import run as trun
from navierstokes3d_tpu_torch.utils import timers
from navierstokes3d_tpu_torch.utils.profiling import trace

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)


def test_watchdog_fires_on_stall():
    r = _run("""
import time
from navierstokes3d_tpu_torch.utils.timers import StallWatchdog
StallWatchdog(0.3, message="resume me").start()
time.sleep(30)   # a 'wedged device call': never beats
print("unreachable")
""")
    assert r.returncode == 3, (r.returncode, r.stderr[-500:])
    assert "STALL" in r.stderr and "resume me" in r.stderr
    assert "unreachable" not in r.stdout


def test_watchdog_quiet_with_beats_and_stop():
    r = _run("""
import time
from navierstokes3d_tpu_torch.utils.timers import StallWatchdog
w = StallWatchdog(0.5).start()
for _ in range(8):      # regular progress for ~1.2 s > timeout
    time.sleep(0.15)
    w.beat()
w.stop()
time.sleep(0.8)         # after stop() a stall must not fire
print("done")
""")
    assert r.returncode == 0, (r.returncode, r.stderr[-500:])
    assert "done" in r.stdout and "STALL" not in r.stderr


def test_cli_stall_timeout_completes(tmp_path, capsys):
    """A healthy run with --stall-timeout armed completes, and the
    watchdog is stopped when main returns."""
    assert trun.main(["--nx", "9", "--nt", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "ck"),
                      "--stall-timeout", "600", "--quiet"]) == 0
    assert "STALL" not in capsys.readouterr().err


def test_cli_stall_timeout_fires(tmp_path):
    """A step that never returns (a stand-in for a wedged device call):
    the CLI exits with code 3 and says how to resume."""
    r = _run(f"""
import time
from navierstokes3d_tpu_torch import run
from navierstokes3d_tpu_torch.models.chorin import ChorinSolver
ChorinSolver.step = lambda self, st: time.sleep(60)
run.main(["--nx", "9", "--nt", "2", "--device", "cpu",
          "--checkpoint-every", "1", "--ckpt-dir", {str(tmp_path)!r},
          "--stall-timeout", "0.5"])
""")
    assert r.returncode == 3, (r.returncode, r.stderr[-500:])
    assert "STALL" in r.stderr and "--resume" in r.stderr


def test_run_timer_matches_jax():
    recs = [(1, 0.5, 10, 1e-4), (2, 0.25, 20, 2e-4), (3, 0.25, 30, 3e-4)]
    a, b = timers.RunTimer(), jtimers.RunTimer()
    for mod, t in ((timers, a), (jtimers, b)):
        t.records.extend(mod.StepRecord(*r) for r in recs)
    for skip in (0, 1, 5):
        assert a.summary(skip) == b.summary(skip)
    assert timers.RunTimer().summary() == {}


def test_trace_context_manager(tmp_path):
    with trace(str(tmp_path / "t2")) as d:
        (torch.ones((8, 8)) * 2).sum()
    files = glob.glob(os.path.join(d, "*.json"))
    assert files and os.path.getsize(files[0]) > 0


NEW_MODULES = ("navierstokes3d_tpu_torch.ops.fdm_poisson",
               "navierstokes3d_tpu_torch.io",
               "navierstokes3d_tpu_torch.io.native",
               "navierstokes3d_tpu_torch.io.binio",
               "navierstokes3d_tpu_torch.io.matio",
               "navierstokes3d_tpu_torch.io.checkpoint",
               "navierstokes3d_tpu_torch.io.viz",
               "navierstokes3d_tpu_torch.compat_api",
               "navierstokes3d_tpu_torch.utils.timers",
               "navierstokes3d_tpu_torch.utils.profiling",
               "navierstokes3d_tpu_torch.run")


@pytest.mark.parametrize("target", ["modules", "chip_smoke"])
def test_no_jax_import(target):
    """Every new module of the port, and chip_smoke.py, import without
    jax and without the JAX package (io's package import leaves viz, and
    so matplotlib, unimported)."""
    if target == "modules":
        body = "".join(f"import {m}\n" for m in NEW_MODULES[:4]) + (
            "assert 'navierstokes3d_tpu_torch.io.viz' not in sys.modules\n"
            "assert 'matplotlib' not in sys.modules\n") + "".join(
            f"import {m}\n" for m in NEW_MODULES[4:])
    else:
        body = ("import importlib.util\n"
                "spec = importlib.util.spec_from_file_location("
                "'chip_smoke', 'chip_smoke.py')\n"
                "spec.loader.exec_module("
                "importlib.util.module_from_spec(spec))\n")
    code = ("import sys\n" + body +
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'navierstokes3d_tpu.', "
            "'flax')) or m == 'navierstokes3d_tpu')\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
