"""Driver framework + builtin drivers (a copy of
``nomad_tpu/client/driver/__init__.py``; reference: client/driver/).

The package registers every builtin driver in ``BUILTIN_DRIVERS``
(``driver.load_builtins``), in the order the JAX package's client
registers them: ``mock_driver``, the exec family (``raw_exec``,
``exec``, ``java``, ``qemu``, ``docker``) and the containers (``rkt``,
``lxc``).  A client fingerprints each and publishes ``driver.<name>``
where the host has it.

The names below are imported when first read (PEP 562), and the first
read registers the builtins: a task's supervisor runs as
``python -m <package>.supervisor`` and loads only the standard library
and its ``supervisor``, ``executor`` and ``cgroups`` modules, not
``driver.py`` and the structs it imports.
"""

import importlib

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


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    driver = importlib.import_module(f"{__name__}.driver")
    driver.load_builtins()
    value = getattr(driver, name)
    globals()[name] = value
    return value
