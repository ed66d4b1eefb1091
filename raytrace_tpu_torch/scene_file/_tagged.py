"""Helpers for (de)serializing externally-tagged snake_case enum unions.

The reference's serde derive emits enums as ``{"variant_name": {..fields..}}``
(externally tagged) with snake_case variant names (e.g. ``uv_sphere``,
``vertical_gradient``).  These helpers let each schema module register its
variants and round-trip them without any per-variant boilerplate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type


class SceneError(ValueError):
    """Raised for malformed or semantically invalid scene files."""


def _field_to_json(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        if hasattr(value, "to_json"):
            return value.to_json()
        return {
            k: _field_to_json(v)
            for k, v in dataclasses.asdict(value).items()
            if v is not None
        }
    if isinstance(value, (list, tuple)):
        return [_field_to_json(v) for v in value]
    return value


def dataclass_to_json(obj: Any, *, drop_none: bool = True) -> Dict[str, Any]:
    """Serialize a flat dataclass to a JSON dict (fields in declaration order)."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None and drop_none:
            continue
        out[f.name] = _field_to_json(v)
    return out


class TaggedUnion:
    """Registry mapping snake_case tags <-> dataclass variants for one union."""

    def __init__(self, union_name: str):
        self.union_name = union_name
        self._by_tag: Dict[str, Type] = {}

    def variant(self, tag: str):
        """Class decorator registering `cls` under `tag`."""

        def deco(cls):
            cls._tag = tag
            cls._union = self
            self._by_tag[tag] = cls

            def to_json(self_, _tag=tag):
                return {_tag: dataclass_to_json(self_)}

            if "to_json" not in cls.__dict__:
                cls.to_json = to_json
            return cls

        return deco

    def from_json(self, data: Dict[str, Any]) -> Any:
        if not isinstance(data, dict) or len(data) != 1:
            raise SceneError(
                f"{self.union_name}: expected a single-key tagged object, got {data!r}"
            )
        (tag, fields), = data.items()
        cls = self._by_tag.get(tag)
        if cls is None:
            raise SceneError(
                f"{self.union_name}: unknown variant '{tag}' "
                f"(known: {sorted(self._by_tag)})"
            )
        if hasattr(cls, "from_json_fields"):
            return cls.from_json_fields(fields)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in fields:
                kwargs[f.name] = _coerce(f.type, fields[f.name])
            elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise SceneError(
                    f"{self.union_name}.{tag}: missing required field '{f.name}'"
                )
        extra = set(fields) - {f.name for f in dataclasses.fields(cls)}
        if extra:
            raise SceneError(f"{self.union_name}.{tag}: unknown fields {sorted(extra)}")
        return cls(**kwargs)


def _coerce(_type_hint, value):
    # Scene files carry only JSON primitives / arrays; nested dataclasses are
    # handled by variant-specific `from_json_fields` overrides.
    return value
