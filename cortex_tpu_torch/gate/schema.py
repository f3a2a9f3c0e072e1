"""Per-kind metadata schema validation.

Parity: crates/cortex-core/src/gate/schema.rs:13-170 — required fields,
type checks (string/number/boolean/array), numeric min/max, allowed
values; kinds without schemas pass freely.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..types import Node

STRING = "string"
NUMBER = "number"
BOOLEAN = "boolean"
ARRAY = "array"


@dataclass
class FieldSchema:
    field_type: Optional[str] = None        # string|number|boolean|array
    min: Optional[float] = None
    max: Optional[float] = None
    allowed_values: Optional[List[str]] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FieldSchema":
        return FieldSchema(
            field_type=d.get("type"),
            min=d.get("min"), max=d.get("max"),
            allowed_values=d.get("allowed_values"))


@dataclass
class KindSchema:
    required_fields: List[str] = field(default_factory=list)
    fields: Dict[str, FieldSchema] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "KindSchema":
        return KindSchema(
            required_fields=list(d.get("required_fields", [])),
            fields={k: FieldSchema.from_dict(v)
                    for k, v in d.get("fields", {}).items()})


@dataclass
class SchemaViolation:
    field: str
    message: str

    def __str__(self) -> str:
        return f"{self.field}: {self.message}"


def _json_type_name(v: Any) -> str:
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    return "null"


def _type_ok(expected: str, v: Any) -> bool:
    if expected == STRING:
        return isinstance(v, str)
    if expected == NUMBER:
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if expected == BOOLEAN:
        return isinstance(v, bool)
    if expected == ARRAY:
        return isinstance(v, list)
    return True


class SchemaValidator:
    def __init__(self, schemas: Optional[Dict[str, KindSchema]] = None):
        self.schemas = schemas or {}

    @staticmethod
    def empty() -> "SchemaValidator":
        return SchemaValidator({})

    @property
    def has_schemas(self) -> bool:
        return bool(self.schemas)

    def validate(self, node: Node) -> List[SchemaViolation]:
        """Empty list = pass (kinds without schemas always pass)."""
        schema = self.schemas.get(node.kind)
        if schema is None:
            return []
        violations: List[SchemaViolation] = []
        md = node.metadata

        for name in schema.required_fields:
            if name not in md:
                violations.append(SchemaViolation(name, "required field missing"))

        for name, fs in schema.fields.items():
            if name not in md:
                continue
            v = md[name]
            if fs.field_type is not None and not _type_ok(fs.field_type, v):
                violations.append(SchemaViolation(
                    name, f"expected type {fs.field_type}, "
                          f"got {_json_type_name(v)}"))
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if fs.min is not None and v < fs.min:
                    violations.append(SchemaViolation(
                        name, f"value {v} is below minimum {fs.min}"))
                if fs.max is not None and v > fs.max:
                    violations.append(SchemaViolation(
                        name, f"value {v} exceeds maximum {fs.max}"))
            if fs.allowed_values is not None:
                val = v if isinstance(v, str) else str(v)
                if val not in fs.allowed_values:
                    violations.append(SchemaViolation(
                        name, f"value {val!r} not in allowed values: "
                              f"{fs.allowed_values}"))
        return violations
