"""Core registration stack of the port: transforms, NN search (brute force
and voxel grid), ICP (point-to-point and point-to-plane), the coarse-to-fine
pyramid, engines, the Table-I API, registration health and streaming
scan-to-map odometry. Surface normals live in ``repro_torch.data.normals``,
which imports this package."""
from repro_torch.core.api import FppsICP
from repro_torch.core.engine import (CallableEngine, KernelEngine,
                                     RegistrationEngine, TorchEngine,
                                     available_engines, get_engine,
                                     register_engine)
from repro_torch.core.health import (FAILED, OK, SUSPECT, HealthThresholds,
                                     RegistrationHealth, assess_registration,
                                     health_thresholds_from_reference,
                                     host_result, normal_equation_condition,
                                     plane_normal_matrix, pose_jump)
from repro_torch.core.icp import (ICPParams, ICPResult, ICPState, icp,
                                  icp_batch, icp_fixed_iterations,
                                  params_from_reference, result_to_numpy,
                                  scrub_nonfinite)
from repro_torch.core.nn_search import nn_search
from repro_torch.core.nn_search_grid import GridQueryStats
from repro_torch.core.odometry import (KIND_BOOTSTRAP, KIND_EMPTY,
                                       KIND_REGISTER, FrameDiagnostics,
                                       FuseRequest, OdometryConfig,
                                       OdometryPipeline, PreparedFrame,
                                       odometry_config_from_reference)
from repro_torch.core.point_to_plane import (solve_normal_equations,
                                             solve_point_to_plane)
from repro_torch.core.pyramid import PyramidEngine, icp_pyramid, polish_stats
from repro_torch.core.transform import (estimate_rigid_transform,
                                        make_transform, transform_points)
from repro_torch.data.voxelize import build_voxel_grid, voxel_downsample

__all__ = [
    "FppsICP", "CallableEngine", "KernelEngine", "RegistrationEngine",
    "TorchEngine", "available_engines", "get_engine", "register_engine",
    "ICPParams", "ICPResult", "ICPState", "icp", "icp_batch",
    "icp_fixed_iterations", "params_from_reference", "result_to_numpy",
    "scrub_nonfinite", "nn_search", "GridQueryStats", "PyramidEngine",
    "icp_pyramid", "polish_stats", "build_voxel_grid", "voxel_downsample",
    "estimate_rigid_transform", "make_transform", "transform_points",
    "solve_normal_equations", "solve_point_to_plane",
    "OK", "SUSPECT", "FAILED", "HealthThresholds", "RegistrationHealth",
    "assess_registration", "health_thresholds_from_reference", "host_result",
    "normal_equation_condition", "plane_normal_matrix", "pose_jump",
    "KIND_BOOTSTRAP", "KIND_EMPTY", "KIND_REGISTER", "FrameDiagnostics",
    "FuseRequest", "OdometryConfig", "OdometryPipeline", "PreparedFrame",
    "odometry_config_from_reference",
]
