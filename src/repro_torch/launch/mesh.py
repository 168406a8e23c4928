"""Meshes on one card: the port's counterpart of ``repro/launch/mesh.py``.

The reference lays its steps out over TPU device meshes: the production
pod meshes (16x16, and 2x16x16 across two pods) and arbitrary meshes for
elastic rescaling.  The port runs on one card, where those meshes have no
counterpart, so nothing here builds or emulates a mesh.  ``smoke_mesh``
gives the reference's own answer on one device, ``None`` (run unsharded,
as ``launch/train.py`` does), and ``data_axes(None)`` the batch axes of
that, none.  As ``pipe_mesh`` and ``farm_mesh`` in the data plane
(``core/data_engine/state.py``, ``core/model_engine/engine_farm.py``),
the mesh builders raise, and ``check_card_mesh`` refuses a dry run's
mesh or sharding rules other than the card's.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Tuple

NO_MESH = ("the TPU pod meshes (16x16, 2x16x16) and the meshes of elastic "
           "rescaling have no one-card counterpart: the port runs "
           "unsharded on one card (smoke_mesh() is None)")


def make_production_mesh(*, multi_pod: bool = False) -> None:
    """Raises: the reference's (16, 16) / (2, 16, 16) TPU meshes have no
    counterpart on one card."""
    raise ValueError(f"make_production_mesh(multi_pod={multi_pod}): "
                     f"{NO_MESH}")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> None:
    """Raises: no mesh of any shape is built on one card."""
    raise ValueError(f"make_mesh({shape}, {axes}): {NO_MESH}")


def data_axes(mesh: None) -> Tuple[str, ...]:
    """The axes a batch dimension is sharded over: none on one card
    (``mesh`` is ``smoke_mesh()``'s ``None``)."""
    if mesh is not None:
        raise ValueError(f"data_axes of {mesh!r}: {NO_MESH}")
    return ()


def smoke_mesh() -> None:
    """The mesh of a local run: ``None``, the reference's answer on one
    device (steps run unsharded)."""
    return None


def check_card_mesh(mesh_kind: str, rules: Optional[Iterable[Any]] = None
                    ) -> None:
    """The dry runs' refusal (``dryrun.run_cell``, ``run_all_dryruns``):
    ``ValueError`` unless the mesh is ``"card"`` and there are no sharding
    rules (a dict of them, or the CLI's ``--rule`` strings)."""
    if mesh_kind != "card":
        raise ValueError(f"mesh {mesh_kind!r}: the TPU pod meshes (16x16, "
                         "2x16x16) have no one-card counterpart; the dry "
                         "run traces one card (mesh 'card')")
    if rules:
        raise ValueError("sharding rules map logical axes onto a TPU mesh; "
                         "one card has no mesh to map them onto")
