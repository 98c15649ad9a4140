"""Fresh interpreters for the port's most sensitive parity tests.

Some comparisons of the port against the JAX package failed in some runs of
the tier-1 command (six workers, files dealt to them by file) and passed in
others, and each passed alone: the engine's parity at 1e-4
(``test_torch_engine.py``) and an elementwise diff map at 1e-5
(``test_torch_caps.py::test_diff_map``). The failing diff map (MAGNITUDE,
``diff_pow`` 1: a square root) was off in exactly the elements, and by
exactly the amounts, that a square root computed as ``x * rsqrt(x)`` with
the 12-bit ``vrsqrtps`` estimate and no Newton step gives (694 of 1230
elements, up to 9.551644e-5): one of the two libraries computed with
another precision in that worker than in a fresh process. In the runs
made since, nothing (rounding mode, flush-to-zero, MKL's accuracy mode and
instruction set, thread counts, XLA's fast-math options) made either
library do so here, so these tests take their numbers from a fresh
interpreter, where nothing that earlier files did to the worker reaches:

- ``run_fresh(module, function, *args)`` calls a function of a test module
  in a new interpreter and returns its (pickled) result;
- ``rerun_in_fresh_process(request)`` runs the calling test alone under
  pytest in a new interpreter and requires it to pass.

The guard below sets a floating-point state of the kind a loaded native
library can leave behind (round toward zero, through ``fesetround``) in
one interpreter and shows that the failing case's diff maps computed there
move, and that ``run_fresh`` from that interpreter still gives a fresh
interpreter's bits.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CHILD_NODE = "VTAMIQ_FRESH_PROCESS_NODE"  # set in a rerun: the node id it runs


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(extra)
    return env


def run_fresh(module: str, function: str, *args, timeout: float = 600):
    """``module.function(*args)`` (a module of tests/) in a new interpreter
    with this process's environment; returns its result."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.pkl")
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        code = (f"import pickle, sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]; "
                f"import {module} as m; "
                f"args = pickle.load(open({os.path.join(tmp, 'args.pkl')!r}, 'rb')); "
                f"pickle.dump(m.{function}(*args), open({out!r}, 'wb'))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_child_env(),
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"{module}.{function} failed in a fresh interpreter:\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(out, "rb") as f:
            return pickle.load(f)


def rerun_in_fresh_process(request, timeout: float = 900) -> bool:
    """Run the calling test alone, under pytest, in a new interpreter and
    require it to pass. Returns True in the calling process (the test then
    returns) and False inside that interpreter (the test runs its body)."""
    node = request.node.nodeid
    if os.environ.get(CHILD_NODE) == node:
        return False
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", node, "-q", "-p", "no:cacheprovider",
             "--basetemp", os.path.join(tmp, "basetemp")],
            cwd=ROOT, env=_child_env(**{CHILD_NODE: node}), capture_output=True, text=True,
            timeout=timeout)
    assert proc.returncode == 0 and "1 passed" in proc.stdout, \
        f"{node} in a fresh interpreter:\n{proc.stdout[-6000:]}\n{proc.stderr[-3000:]}"
    return True


def _set_fp_state():
    """Round toward zero in this thread's floating-point control (x87 and
    MXCSR), through a native call to libm's ``fesetround``."""
    import ctypes
    import ctypes.util
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fe_towardzero = 0xC00  # x86-64 glibc
    if libm.fesetround(fe_towardzero) != 0:
        raise OSError("fesetround failed")


def _diff_maps_after_fp_state():
    """In this interpreter: the diff maps of the case that failed (MAGNITUDE,
    diff_pow 1, two images) before and after the state change, and the ones
    ``run_fresh`` gives after it."""
    import test_torch_caps
    cases = [(test_torch_caps.ts.DIFF_TYPE_MAGNITUDE, 1.0, 2)]
    before = test_torch_caps.diff_map_pairs(cases)
    _set_fp_state()
    after = test_torch_caps.diff_map_pairs(cases)
    return before, after, run_fresh("test_torch_caps", "diff_map_pairs", cases)


def _equal(a, b):
    return all(np.array_equal(a[c][i], b[c][i]) for c in a for i in (0, 1))


def test_fresh_interpreter_is_immune_to_the_fp_state_of_its_caller():
    before, after, fresh = run_fresh("test_torch_process_state", "_diff_maps_after_fp_state")
    assert not _equal(before, after)  # the state moves this interpreter's numbers
    assert _equal(before, fresh)      # a fresh interpreter's bits are the clean ones

