"""Driver framework + builtin drivers (a copy of
``nomad_tpu/client/driver/__init__.py``; reference: client/driver/).

``BUILTIN_DRIVERS`` holds ``mock_driver`` only, registered when this
package is imported; the exec family and the containers are ROADMAP item
28(b), so a job asking for one stays blocked, as on a reference client
whose host lacks the driver."""

from .driver import (
    BUILTIN_DRIVERS,
    Driver,
    DriverAbilities,
    DriverContext,
    DriverError,
    DriverHandle,
    ExecContext,
    RecoverableError,
    StartResponse,
    WaitResult,
    new_driver,
    register_driver,
    validate_driver_config,
)
from . import mock_driver  # noqa: F401  (registers mock_driver)

__all__ = [
    "BUILTIN_DRIVERS",
    "Driver",
    "DriverAbilities",
    "DriverContext",
    "DriverError",
    "DriverHandle",
    "ExecContext",
    "RecoverableError",
    "StartResponse",
    "WaitResult",
    "new_driver",
    "register_driver",
    "validate_driver_config",
]
