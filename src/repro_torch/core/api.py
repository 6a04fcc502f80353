"""PCL-like API, faithful to FPPS Table I (port of ``repro.core.api``).

The paper ships PCL-style setters so developers can swap the accelerator
into existing pipelines; the surface is kept exactly (camelCase and all),
backed by the port's engines (``repro_torch.core.engine``).
``hardwareInitialize`` stands in for the .xclbin load: it initialises the
card and builds the kernel library.

    icp = FppsICP()                  # engine "cuda" on the card
    icp.hardwareInitialize()
    icp.setInputSource(src)          # (N,3) array-like
    icp.setInputTarget(dst)          # (M,3) array-like
    icp.setMaxCorrespondenceDistance(1.0)
    icp.setMaxIterationCount(50)
    icp.setTransformationEpsilon(1e-5)
    T = icp.align()
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import RegistrationEngine, get_engine
from repro_torch.core.icp import (MINIMIZERS, ICPParams, ICPResult,
                                  result_to_numpy)
from repro_torch.core.point_to_plane import ROBUST_KERNELS


class FppsICP:
    """Drop-in ICP object mirroring the FPPS / PCL interface (Table I)."""

    def __init__(self, engine: str | RegistrationEngine = "cuda",
                 chunk: int = 2048, device="cuda", **engine_kwargs):
        """engine: ``"cuda"`` (the CUDA kernel; default), ``"torch"`` (plain
        PyTorch brute force), a ``RegistrationEngine`` instance, or a
        callable ``nn_fn(src, dst) -> (d2, idx)``. ``device`` defaults to
        ``"cuda"`` and raises without it; pass ``"cpu"`` explicitly."""
        self._engine = get_engine(engine, device=device, chunk=chunk,
                                  **engine_kwargs)
        self._device = self._engine.device
        self._source: torch.Tensor | None = None
        self._target: torch.Tensor | None = None
        self._initial_T: torch.Tensor | None = None
        self._max_corr = 1.0
        self._max_iter = 50
        self._eps = 1e-5
        self._minimizer = "point_to_point"
        self._robust_kernel = "none"
        self._robust_scale = 0.5
        self._chunk = chunk
        self._initialized = False
        self._last_result: ICPResult | None = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self._device)

    # -- Table I surface ---------------------------------------------------
    def hardwareInitialize(self) -> None:
        """Initialise the backend (paper: load .xclbin): the card, and the
        engine's kernel library."""
        self._engine.setup()
        self._initialized = True

    def setTransformationMatrix(self, transformationMatrix) -> None:
        self._initial_T = self._tensor(transformationMatrix)

    def setInputSource(self, inputSource) -> None:
        self._source = self._tensor(inputSource)

    def setInputTarget(self, inputTarget) -> None:
        self._target = self._tensor(inputTarget)

    def setMaxCorrespondenceDistance(self, maxCorrespondenceDistance: float
                                     ) -> None:
        self._max_corr = float(maxCorrespondenceDistance)

    def setMaxIterationCount(self, maxIterationCount: int) -> None:
        self._max_iter = int(maxIterationCount)

    def setTransformationEpsilon(self, transformationEpsilon: float) -> None:
        self._eps = float(transformationEpsilon)

    def setMinimizer(self, minimizer: str) -> None:
        """'point_to_point' (paper default) or 'point_to_plane' (accepted
        here, but registration raises until slice 3 ports it)."""
        if minimizer not in MINIMIZERS:
            raise ValueError(f"unknown minimizer {minimizer!r}; "
                             f"expected one of {MINIMIZERS}")
        self._minimizer = minimizer

    def setRobustKernel(self, kind: str, scale: float | None = None) -> None:
        """IRLS reweighting: 'none', 'huber' or 'tukey' (+ optional scale
        in metres: huber's delta / tukey's cutoff)."""
        if kind not in ROBUST_KERNELS:
            raise ValueError(f"unknown robust kernel {kind!r}; "
                             f"expected one of {ROBUST_KERNELS}")
        self._robust_kernel = kind
        if scale is not None:
            self._robust_scale = float(scale)

    def align(self) -> np.ndarray:
        """Run registration; returns the final 4x4 transformation matrix."""
        if not self._initialized:
            self.hardwareInitialize()
        if self._source is None or self._target is None:
            raise ValueError(
                "setInputSource/setInputTarget must be called before align()")
        result = self._engine.register(self._source, self._target,
                                       self._params(), self._initial_T)
        self._last_result = result_to_numpy(result)
        return self._last_result.T

    # -- extras (not in Table I but needed by callers/tests) ----------------
    @property
    def engine(self) -> RegistrationEngine:
        return self._engine

    @property
    def last_result(self) -> ICPResult | None:
        """The last ``align()``'s result, as numpy arrays."""
        return self._last_result

    def hasConverged(self) -> bool:
        return bool(self._last_result.converged) if self._last_result else False

    def getFitnessScore(self) -> float:
        return float(self._last_result.rmse) if self._last_result else float("inf")

    def _params(self) -> ICPParams:
        return ICPParams(max_iterations=self._max_iter,
                         max_correspondence_distance=self._max_corr,
                         transformation_epsilon=self._eps,
                         chunk=self._chunk,
                         minimizer=self._minimizer,
                         robust_kernel=self._robust_kernel,
                         robust_scale=self._robust_scale)
