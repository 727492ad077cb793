"""Feature-type schema DSL: the ``name:Type:opt=...`` spec string.

Port copy of :mod:`geomesa_tpu.schema.sft`, trimmed to the types the
port stores:

    "name:String,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"

- ``*`` marks the default geometry attribute: a ``Point`` (the z3 and z2
  indexes) or an extended geometry, ``LineString``, ``Polygon``, their
  ``Multi`` forms, ``MultiPoint`` or ``Geometry`` (the xz3 and xz2
  indexes).
- per-attribute options after a second ``:`` (``srid=4326``, ...).
- schema-level user data after ``;`` (``geomesa.z3.interval``,
  ``geomesa.index.dtg``, ``geomesa.indices``, ``geomesa.index.layout``,
  ``geomesa.xz.precision``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from geomesa_tpu_torch.curve.binned_time import TimePeriod


class AttributeType(str, Enum):
    STRING = "String"
    INT = "Integer"
    LONG = "Long"
    FLOAT = "Float"
    DOUBLE = "Double"
    BOOLEAN = "Boolean"
    DATE = "Date"
    POINT = "Point"
    LINESTRING = "LineString"
    POLYGON = "Polygon"
    MULTIPOINT = "MultiPoint"
    MULTILINESTRING = "MultiLineString"
    MULTIPOLYGON = "MultiPolygon"
    GEOMETRY = "Geometry"

    @property
    def is_geometry(self) -> bool:
        return self in _GEOM_TYPES


_GEOM_TYPES = {
    AttributeType.POINT,
    AttributeType.LINESTRING,
    AttributeType.POLYGON,
    AttributeType.MULTIPOINT,
    AttributeType.MULTILINESTRING,
    AttributeType.MULTIPOLYGON,
    AttributeType.GEOMETRY,
}

_TYPE_ALIASES = {t.value.lower(): t for t in AttributeType}
_TYPE_ALIASES.update({"int": AttributeType.INT, "str": AttributeType.STRING})


@dataclass(frozen=True)
class AttributeDescriptor:
    name: str
    type: AttributeType
    options: dict = field(default_factory=dict)


@dataclass
class FeatureType:
    """Schema: ordered attributes + index configuration user-data."""

    name: str
    attributes: list[AttributeDescriptor]
    default_geom: str | None = None
    user_data: dict = field(default_factory=dict)

    def __post_init__(self):
        names = [a.name for a in self.attributes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate attribute names in schema: {names}")
        if self.default_geom is None:
            for a in self.attributes:
                if a.type.is_geometry:
                    self.default_geom = a.name
                    break

    def attr(self, name: str) -> AttributeDescriptor:
        for a in self.attributes:
            if a.name == name:
                return a
        raise KeyError(f"no such attribute: {name!r} in {self.name}")

    def __contains__(self, name: str) -> bool:
        return any(a.name == name for a in self.attributes)

    @property
    def geom_field(self) -> str | None:
        return self.default_geom

    @property
    def dtg_field(self) -> str | None:
        """Default date attribute: explicit user-data override, else the first
        Date (an explicit empty override pins 'no default date')."""
        explicit = self.user_data.get("geomesa.index.dtg")
        if explicit is not None:
            return explicit or None
        for a in self.attributes:
            if a.type == AttributeType.DATE:
                return a.name
        return None

    @property
    def geom_is_points(self) -> bool:
        return (
            self.default_geom is not None
            and self.attr(self.default_geom).type == AttributeType.POINT
        )

    @property
    def z3_interval(self) -> TimePeriod:
        return TimePeriod(self.user_data.get("geomesa.z3.interval", "week"))

    @property
    def xz_precision(self) -> int:
        """The XZ curves' resolution ``g`` (``geomesa.xz.precision``, 12)."""
        return int(self.user_data.get("geomesa.xz.precision", 12))

    @property
    def index_layout(self) -> str:
        """Index-layout version (``geomesa.index.layout``): ``current``
        (default) or ``legacy``, the curve generation keys are built with."""
        v = str(self.user_data.get("geomesa.index.layout", "current"))
        return "legacy" if v in ("legacy", "1") else "current"

    @property
    def configured_indices(self) -> list[str] | None:
        """The ``geomesa.indices`` override (index names), or None."""
        v = self.user_data.get("geomesa.indices")
        if not v:
            return None
        return [s.strip() for s in v.split(",") if s.strip()]


def parse_spec(name: str, spec: str) -> FeatureType:
    """Parse a ``SimpleFeatureTypes``-style spec string into a FeatureType."""
    spec = spec.strip()
    if ";" in spec:
        attr_part, ud_part = spec.split(";", 1)
    else:
        attr_part, ud_part = spec, ""

    attributes: list[AttributeDescriptor] = []
    default_geom = None
    for chunk in _split_top(attr_part, ","):
        chunk = chunk.strip()
        if not chunk:
            continue
        is_default = chunk.startswith("*")
        if is_default:
            chunk = chunk[1:]
        fields = chunk.split(":")
        if len(fields) < 2:
            raise ValueError(f"invalid attribute spec: {chunk!r}")
        aname, atype = fields[0].strip(), fields[1].strip()
        try:
            typ = _TYPE_ALIASES[atype.lower()]
        except KeyError:
            raise ValueError(f"unknown attribute type {atype!r} in {chunk!r}") from None
        options = {}
        for opt in fields[2:]:
            if "=" in opt:
                k, v = opt.split("=", 1)
                options[k.strip()] = v.strip()
        attributes.append(AttributeDescriptor(aname, typ, options))
        if is_default:
            if not typ.is_geometry:
                raise ValueError(f"default-geometry marker on non-geometry: {chunk!r}")
            default_geom = aname

    user_data = {}
    if ud_part:
        for kv in _split_top(ud_part, ","):
            if "=" in kv:
                k, v = kv.split("=", 1)
                user_data[k.strip()] = v.strip().strip("'\"")

    return FeatureType(name, attributes, default_geom, user_data)


def _split_top(s: str, sep: str) -> list[str]:
    """Split on ``sep`` outside of quotes."""
    out, cur, q = [], [], None
    for ch in s:
        if q:
            if ch == q:
                q = None
            cur.append(ch)
        elif ch in "'\"":
            q = ch
            cur.append(ch)
        elif ch == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out
