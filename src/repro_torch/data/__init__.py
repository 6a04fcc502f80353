"""Data path of the port: synthetic scenes, shape buckets, voxel grids,
normals, the rolling submap and sensor-fault injectors; ``tokens`` is the
legacy LM stack's synthetic token stream."""
from repro_torch.data.corruption import (FAULT_NAMES, FaultSpec,
                                         apply_faults, fault_seed,
                                         parse_fault_spec)
from repro_torch.data.submap import (STORAGE_MODES, Submap, SubmapParams,
                                     empty_state, encode_state, fuse_state,
                                     state_bytes, state_views,
                                     submap_params_from_reference,
                                     submap_state_from_reference)

__all__ = ["FAULT_NAMES", "FaultSpec", "apply_faults", "fault_seed",
           "parse_fault_spec", "STORAGE_MODES", "Submap", "SubmapParams",
           "empty_state", "encode_state", "fuse_state", "state_bytes",
           "state_views", "submap_params_from_reference",
           "submap_state_from_reference"]
