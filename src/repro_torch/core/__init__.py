"""Core registration stack of the port: transforms, NN search, ICP, engines
and the Table-I API."""
from repro_torch.core.api import FppsICP
from repro_torch.core.engine import (CallableEngine, KernelEngine,
                                     RegistrationEngine, TorchEngine,
                                     available_engines, get_engine,
                                     register_engine)
from repro_torch.core.icp import (ICPParams, ICPResult, ICPState, icp,
                                  icp_batch, icp_fixed_iterations,
                                  params_from_reference, result_to_numpy,
                                  scrub_nonfinite)
from repro_torch.core.nn_search import nn_search
from repro_torch.core.transform import (estimate_rigid_transform,
                                        make_transform, transform_points)

__all__ = [
    "FppsICP", "CallableEngine", "KernelEngine", "RegistrationEngine",
    "TorchEngine", "available_engines", "get_engine", "register_engine",
    "ICPParams", "ICPResult", "ICPState", "icp", "icp_batch",
    "icp_fixed_iterations", "params_from_reference", "result_to_numpy",
    "scrub_nonfinite", "nn_search", "estimate_rigid_transform",
    "make_transform", "transform_points",
]
