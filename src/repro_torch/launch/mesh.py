"""The serving mesh of the sharded executor, the counterpart of
``repro.launch.mesh.make_serving_mesh``.

The reference's mesh is a ``jax.sharding.Mesh`` over ``n_data_shards x
model_shards`` XLA devices and raises when there are fewer.  The port's is
a description: D x M logical shards of one torch device (ROADMAP C15, a
deliberate divergence, for both axes).  The sharded executor runs the
``"data"`` shards as a leading axis on its survivor buffers and the
``"model"`` shards as column slices of each stage's slab, scored in turn
and summed (``launch.shardings``); every shard's kernels are launched on
the same card, and negotiation still never picks the sharded backend on
one card.  The training meshes are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["DATA_AXIS", "MODEL_AXIS", "ServingMesh", "batch_axes", "make_serving_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """``axis_names`` and ``shape`` (axis -> size) as a ``jax.sharding.Mesh``
    has them, and the torch ``device`` every shard runs on."""

    axis_names: tuple
    shape: dict
    device: torch.device


def make_serving_mesh(n_data_shards: int, model_shards: int = 1, device="cuda") -> ServingMesh:
    """A ``("data",)`` mesh of ``n_data_shards`` logical shards on ``device``
    (the card unless the CPU is named), or with ``model_shards > 1`` a
    ``("data", "model")`` mesh of ``n_data_shards x model_shards``.  Any
    shard count is accepted: the shards share the device.
    ``model_shards=1`` gives the 1-D mesh, so its callers run the 1-D
    program as before."""
    n = int(n_data_shards)
    if n < 1:
        raise ValueError(f"n_data_shards must be >= 1, got {n}")
    m = int(model_shards)
    if m < 1:
        raise ValueError(f"model_shards must be >= 1, got {m}")
    dev = resolve_device(device)
    if m > 1:
        return ServingMesh((DATA_AXIS, MODEL_AXIS), {DATA_AXIS: n, MODEL_AXIS: m}, dev)
    return ServingMesh((DATA_AXIS,), {DATA_AXIS: n}, dev)


def batch_axes(mesh: ServingMesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
