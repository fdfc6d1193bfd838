"""The serving mesh of the sharded executor, the counterpart of
``repro.launch.mesh.make_serving_mesh`` (its data axis).

The reference's mesh is a ``jax.sharding.Mesh`` over ``n_data_shards``
XLA devices and raises when there are fewer.  The port's is a description:
D logical shards of one torch device, which the sharded executor runs as a
leading shard axis on its buffers, every shard's kernels launched on the
same card (ROADMAP C15: a deliberate divergence; negotiation still never
picks the sharded backend on one card).  The model axis, and with it the
training meshes, are the second part of ROADMAP A15.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["DATA_AXIS", "MODEL_AXIS", "MODEL_AXIS_TODO", "ServingMesh", "batch_axes",
           "make_serving_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
MODEL_AXIS_TODO = (
    "a model axis (model_shards > 1) is ROADMAP A15, second part (the model axis), "
    "not ported yet"
)


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """``axis_names`` and ``shape`` (axis -> size) as a ``jax.sharding.Mesh``
    has them, and the torch ``device`` every shard runs on."""

    axis_names: tuple
    shape: dict
    device: torch.device


def make_serving_mesh(n_data_shards: int, model_shards: int = 1, device="cuda") -> ServingMesh:
    """A ``("data",)`` mesh of ``n_data_shards`` logical shards on ``device``
    (the card unless the CPU is named).  Any shard count is accepted: the
    shards share the device.  ``model_shards > 1`` raises."""
    n = int(n_data_shards)
    if n < 1:
        raise ValueError(f"n_data_shards must be >= 1, got {n}")
    m = int(model_shards)
    if m < 1:
        raise ValueError(f"model_shards must be >= 1, got {m}")
    if m > 1:
        raise ValueError(MODEL_AXIS_TODO)
    return ServingMesh((DATA_AXIS,), {DATA_AXIS: n}, resolve_device(device))


def batch_axes(mesh: ServingMesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
