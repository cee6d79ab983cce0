"""The production layout on one card (the reference's ``launch/mesh.py``).

The reference builds a 16 x 16 (or 2 x 16 x 16) device mesh with axes
("data", "model") (and "pod"); the port runs on one NVIDIA H100, so its
production layout is that mesh at size 1 x 1: every axis one device,
every leaf whole on it.  ``make_production_mesh`` returns it, and the
step builders (``launch/steps.py``) take it as the reference's take a
mesh.  Like the reference's it is a function that touches no device
state: the layout names no device, and the dry run builds its steps on
any host.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's layout: axis name -> size (all 1 on one card)."""
    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The one-card layout, ("data", "model") of size 1 x 1.  The
    reference's two-pod mesh (512 devices) has no one-card counterpart:
    ``multi_pod=True`` raises."""
    if multi_pod:
        raise ValueError("multi_pod: the two-pod mesh needs 512 devices; "
                         "the port runs on one card")
    return Mesh(shape={"data": 1, "model": 1})


def data_axes(mesh: Mesh) -> tuple:
    """The axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def tp_size(mesh: Mesh) -> int:
    return mesh.shape["model"]


def dp_size(mesh: Mesh) -> int:
    size = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        size *= mesh.shape["pod"]
    return size
