"""Type registries: the JAX analogue of g2o's Factory.

The reference registers C++ classes under string tags via static proxies
(g2o/core/factory.h:49-120, G2O_REGISTER_TYPE) and constructs per-element
objects with virtual dispatch. Here a *type* is a declarative record holding
pure functions; elements never exist individually — every vertex/edge lives in
a struct-of-arrays table keyed by its type, and the per-type functions are
vmapped over the whole table (this replaces virtual `computeError`
/`oplusImpl` dispatch with type-grouped batching).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "VertexType", "EdgeType", "ParameterType",
    "register_vertex_type", "register_edge_type", "register_parameter_type",
    "register_tag_alias",
    "vertex_type", "edge_type", "parameter_type",
    "vertex_type_by_tag", "edge_type_by_tag", "parameter_type_by_tag",
    "registered_vertex_types", "registered_edge_types", "renamed_types_lookup",
]


@dataclass(frozen=True)
class VertexType:
    """A vertex (state-variable) type living on a manifold.

    Replaces BaseVertex<D,T> subclasses (g2o/core/base_vertex.h:52): the
    estimate is a flat ``ambient_dim`` vector, `retract` is oplusImpl, and
    `origin` is setToOriginImpl.
    """
    name: str                     # canonical registry key, e.g. "se2"
    tag: str                      # .g2o tag, e.g. "VERTEX_SE2"
    ambient_dim: int              # parameters stored per vertex
    tangent_dim: int              # minimal (local) dimension D
    retract: Callable             # (params[P], delta[D]) -> params[P]
    origin: Callable              # (dtype) -> params[P]
    # IO: file numbers <-> params (identity for most types)
    file_dim: Optional[int] = None
    from_file: Optional[Callable] = None   # np [file_dim] -> np [P]
    to_file: Optional[Callable] = None     # np [P] -> np [file_dim]
    marginalizable: bool = False  # landmark-like: eligible for Schur elimination
    extra_tags: tuple = ()        # alternate .g2o tags parsed as this type

    @property
    def io_dim(self):
        return self.file_dim if self.file_dim is not None else self.ambient_dim


@dataclass(frozen=True)
class EdgeType:
    """An error-term (constraint) type between ``len(vertex_types)`` vertices.

    Replaces BaseUnaryEdge/BaseBinaryEdge/BaseMultiEdge subclasses
    (g2o/core/base_binary_edge.h:41): `error` is computeError as a pure
    function; the Jacobian comes from jax.jacfwd on the tangent unless
    the type supplies an analytic `jacobian`.
    """
    name: str
    tag: str
    vertex_types: tuple           # names of VertexTypes per slot
    error_dim: int                # D of the residual (information is DxD)
    measurement_dim: int          # numbers stored per edge (internal)
    error: Callable               # (vparams: tuple, meas[M], pdata: tuple) -> r[D]
    # Optional analytic jacobian: same args -> tuple of [D, tangent_dim_s]
    jacobian: Optional[Callable] = None
    # IO: file measurement numbers -> internal measurement
    file_meas_dim: Optional[int] = None
    from_file: Optional[Callable] = None
    to_file: Optional[Callable] = None
    param_types: tuple = ()       # names of ParameterTypes resolved per edge
    extra_tags: tuple = ()
    # Host-side numpy rule for the spanning-tree initializer: given all slot
    # params, the measurement and parameter data, produce an estimate for
    # `slot` (Edge::initialEstimate analogue). None = cannot initialize.
    initial_estimate: Optional[Callable] = None

    @property
    def num_vertices(self):
        return len(self.vertex_types)

    @property
    def io_meas_dim(self):
        return self.file_meas_dim if self.file_meas_dim is not None else self.measurement_dim


@dataclass(frozen=True)
class ParameterType:
    """A graph-global shared parameter (sensor offset, camera intrinsics).

    Replaces g2o::Parameter / ParameterContainer (g2o/core/parameter.h:36-53):
    parameters are read before the rest of the file and resolved per edge by
    integer id (optimizable_graph.cpp:359).
    """
    name: str
    tag: str                      # e.g. "PARAMS_SE2OFFSET"
    dim: int                      # internal storage width
    file_dim: Optional[int] = None
    from_file: Optional[Callable] = None
    to_file: Optional[Callable] = None

    @property
    def io_dim(self):
        return self.file_dim if self.file_dim is not None else self.dim


_VERTEX_TYPES: dict = {}
_EDGE_TYPES: dict = {}
_PARAMETER_TYPES: dict = {}
_VERTEX_BY_TAG: dict = {}
_EDGE_BY_TAG: dict = {}
_PARAMETER_BY_TAG: dict = {}


def register_vertex_type(vt: VertexType) -> VertexType:
    if vt.name in _VERTEX_TYPES and _VERTEX_TYPES[vt.name] is not vt:
        raise ValueError(f"vertex type {vt.name!r} already registered")
    _VERTEX_TYPES[vt.name] = vt
    for tag in (vt.tag, *vt.extra_tags):
        _VERTEX_BY_TAG[tag] = vt
    return vt


def register_edge_type(et: EdgeType) -> EdgeType:
    if et.name in _EDGE_TYPES and _EDGE_TYPES[et.name] is not et:
        raise ValueError(f"edge type {et.name!r} already registered")
    for v in et.vertex_types:
        if v not in _VERTEX_TYPES:
            raise ValueError(f"edge type {et.name!r} references unknown vertex type {v!r}")
    _EDGE_TYPES[et.name] = et
    for tag in (et.tag, *et.extra_tags):
        _EDGE_BY_TAG[tag] = et
    return et


def register_parameter_type(pt: ParameterType) -> ParameterType:
    _PARAMETER_TYPES[pt.name] = pt
    _PARAMETER_BY_TAG[pt.tag] = pt
    return pt


def register_tag_alias(alias: str, existing_tag: str):
    """Map an additional .g2o tag to an already-registered type (used for the
    DEPRECATED_* legacy tags, types/deprecated/slam3d/types_slam3d.cpp)."""
    for table in (_VERTEX_BY_TAG, _EDGE_BY_TAG, _PARAMETER_BY_TAG):
        if existing_tag in table:
            table[alias] = table[existing_tag]
            return table[alias]
    raise KeyError(f"no type registered under tag {existing_tag!r}")


def vertex_type(name: str) -> VertexType:
    return _VERTEX_TYPES[name]


def edge_type(name: str) -> EdgeType:
    return _EDGE_TYPES[name]


def parameter_type(name: str) -> ParameterType:
    return _PARAMETER_TYPES[name]


def vertex_type_by_tag(tag: str) -> Optional[VertexType]:
    return _VERTEX_BY_TAG.get(tag)


def edge_type_by_tag(tag: str) -> Optional[EdgeType]:
    return _EDGE_BY_TAG.get(tag)


def parameter_type_by_tag(tag: str) -> Optional[ParameterType]:
    return _PARAMETER_BY_TAG.get(tag)


def registered_vertex_types():
    return dict(_VERTEX_TYPES)


def registered_edge_types():
    return dict(_EDGE_TYPES)


def renamed_types_lookup(mapping: str) -> dict:
    """Parse a g2o-style renamed-types string "oldtag=newtag,..." into a
    tag->tag dict (setRenamedTypesFromString, optimizable_graph.cpp:714)."""
    out = {}
    for item in mapping.split(","):
        item = item.strip()
        if not item:
            continue
        old, _, new = item.partition("=")
        if not new:
            raise ValueError(f"invalid renamed-types entry {item!r}")
        out[old.strip()] = new.strip()
    return out
