"""Typed topic schemas (`weed/mq/schema/`: the reference types topics with
protobuf descriptors; the rebuild's JSON control plane uses a JSON field
schema with the same intent — reject malformed records at publish time).

Schema definition, stored in topic.conf:

    {"fields": [
        {"name": "id",    "type": "int",    "required": true},
        {"name": "tags",  "type": "list"},
        {"name": "meta",  "type": "dict"},
        {"name": "score", "type": "float",  "required": false}
    ]}

The port's copy of `seaweedfs_tpu/mq/schema.py`, whole.
"""

from __future__ import annotations

_TYPES = {
    "string": str,
    "int": int,
    "float": (int, float),
    "bool": bool,
    "bytes": str,  # base64/hex text on the JSON wire
    "list": list,
    "dict": dict,
}


class SchemaError(ValueError):
    pass


def validate_schema_def(schema: dict) -> dict:
    """Validate a schema definition at topic-create time; returns it."""
    if not isinstance(schema, dict):
        raise SchemaError("schema must be an object")
    fields = schema.get("fields")
    if not isinstance(fields, list) or not fields:
        raise SchemaError("schema.fields must be a non-empty list")
    seen = set()
    for f in fields:
        if not isinstance(f, dict) or not f.get("name"):
            raise SchemaError(f"bad field {f!r}")
        if f["name"] in seen:
            raise SchemaError(f"duplicate field {f['name']!r}")
        seen.add(f["name"])
        if f.get("type", "string") not in _TYPES:
            raise SchemaError(
                f"field {f['name']!r}: unknown type {f.get('type')!r}"
                f" (know {sorted(_TYPES)})"
            )
        if not isinstance(f.get("required", True), bool):
            raise SchemaError(f"field {f['name']!r}: required must be bool")
    return schema


def validate_record(schema: dict, value) -> None:
    """Reject a published value that does not match the topic schema."""
    if not isinstance(value, dict):
        raise SchemaError("schema'd topics take object values")
    fields = {f["name"]: f for f in schema["fields"]}
    for name, f in fields.items():
        if name not in value:
            if f.get("required", True):
                raise SchemaError(f"missing required field {name!r}")
            continue
        want = _TYPES[f.get("type", "string")]
        got = value[name]
        if isinstance(got, bool) and f.get("type") in ("int", "float"):
            raise SchemaError(f"field {name!r}: bool is not {f.get('type')}")
        if not isinstance(got, want):
            raise SchemaError(
                f"field {name!r}: expected {f.get('type', 'string')},"
                f" got {type(got).__name__}"
            )
    extra = set(value) - set(fields)
    if extra:
        raise SchemaError(f"unknown fields {sorted(extra)}")
