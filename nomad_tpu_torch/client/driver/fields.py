"""Driver-config field schemas (a copy of
``nomad_tpu/client/driver/fields.py``; reference: helper/fields
FieldSchema + FieldData, used by every driver's Validate to type-check
its task config map before start)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class FieldSchema:
    """One config field: expected type, requiredness."""

    __slots__ = ("type", "required")

    def __init__(self, type: str = "string", required: bool = False):
        self.type = type          # string | int | bool | list | map
        self.required = required


_CHECKS = {
    "string": lambda v: isinstance(v, str),
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    # coercible variants for drivers that cast at start time
    # (helper/fields is similarly WeaklyTyped for HCL-decoded maps):
    "intlike": lambda v: (isinstance(v, int) and not isinstance(v, bool))
    or (isinstance(v, str) and (v.lstrip("-").isdigit() if v else False)),
    "duration": lambda v: isinstance(v, (str, int, float))
    and not isinstance(v, bool),
    "bool": lambda v: isinstance(v, bool) or v in ("true", "false"),
    "boollike": lambda v: isinstance(v, bool) or str(v).lower() in (
        "true", "false", "1", "0", "yes", "no"),
    "list": lambda v: isinstance(v, (list, tuple)),
    "map": lambda v: isinstance(v, dict),
}


def validate_fields(config: Optional[Dict[str, Any]],
                    schema: Dict[str, FieldSchema],
                    strict: bool = False) -> List[str]:
    """Validate a driver config map against its schema
    (helper/fields FieldData.Validate): type mismatches, missing required
    fields, and — when strict — unknown keys.  Returns problems."""
    problems: List[str] = []
    config = config or {}
    if not isinstance(config, dict):
        return ["driver config must be a map"]
    for key, fs in schema.items():
        if key not in config:
            if fs.required:
                problems.append(f"missing required field {key!r}")
            continue
        check = _CHECKS.get(fs.type)
        if check is not None and not check(config[key]):
            problems.append(
                f"field {key!r} must be of type {fs.type}, "
                f"got {type(config[key]).__name__}")
            continue
        if fs.required and fs.type == "string" and config[key] == "":
            problems.append(f"field {key!r} must not be empty")
    if strict:
        for key in config:
            if key not in schema:
                problems.append(f"unknown driver config field {key!r}")
    return problems
