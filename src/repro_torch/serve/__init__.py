"""Serving layer of the port: the multi-stream registration service
(``registration_service``), on one device or sharded over several; the
legacy lockstep LM generate engine (``engine``) and the VQ modality
frontends (``modality``)."""
from repro_torch.serve.registration_service import (
    RegistrationService, ServiceConfig, StreamReport,
    service_config_from_reference)

__all__ = ["RegistrationService", "ServiceConfig", "StreamReport",
           "service_config_from_reference"]
