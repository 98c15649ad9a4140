"""MATLAB bridge (a copy of ``vtamiq_tpu/utils/matlab_bridge.py``; the
reference's utils/matlab/matlab_wrapper.py is dead code: it imports a
nonexistent module at line 1 and is unreachable).

Provided as a functional optional bridge: runs a MATLAB function over
.mat tempfiles when the ``matlab.engine`` package is installed; raises a
clear error otherwise. Nothing in the framework depends on it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np


class MatlabWrapper:
    def __init__(self, matlab_root: str = "."):
        try:
            import matlab.engine  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "MatlabWrapper requires the 'matlab.engine' package "
                "(MATLAB installation with the Python engine).") from e
        import matlab.engine
        self.engine = matlab.engine.start_matlab()
        self.engine.addpath(self.engine.genpath(matlab_root))

    def call(self, func_name: str, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Round-trip arrays through .mat files and call a MATLAB function
        taking (in_path, out_path)."""
        import scipy.io
        with tempfile.TemporaryDirectory() as tmp:
            in_path = os.path.join(tmp, "in.mat")
            out_path = os.path.join(tmp, "out.mat")
            scipy.io.savemat(in_path, inputs)
            getattr(self.engine, func_name)(in_path, out_path, nargout=0)
            return scipy.io.loadmat(out_path)

    def close(self):
        self.engine.quit()
