"""Column slices of the cascade's stage slabs over a serving mesh's
``"model"`` axis, the counterpart of the cascade-slab part of
``repro.launch.shardings`` (``split_columns``, ``stage_column_slices``,
``model_stacked_shardings``).

A cascade-ordered param array has its column (base-model) axis first:
stage s owns columns [t0[s], t0[s] + W).  A 2-D ``("data", "model")`` mesh
splits every stage's W columns into M contiguous slices, so model shard j
holds columns [j * w_local, (j + 1) * w_local) of every stage, and summing
the M zero-padded score blocks (the reference's one ``psum`` over
``"model"``) gives the whole (cap, W) block bit for bit: each block is
zero outside its own slice.

On one card the M model shards are logical (ROADMAP C15): each slice is a
contiguous tensor of its own on the mesh's device, scored in turn.  The
reference's FSDP / TP rules (``param_pspec``, ``cache_pspec`` and the
``*_shardings`` of the LM) are not here: they are the third part of
ROADMAP A15.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["model_stacked_shards", "split_columns", "stage_column_slices"]


def split_columns(width: int, model_shards: int) -> tuple[int, int]:
    """Contiguous split of a ``width``-column stage over ``model_shards``
    model shards -> ``(w_local, w_global)``: every shard owns ``w_local =
    ceil(width / model_shards)`` columns, and ``w_global = model_shards *
    w_local >= width`` is the padded global width.  The trailing ``w_global
    - width`` columns are dropped before the decide, so a split that does
    not divide costs padding, never correctness."""
    w = int(width)
    m = int(model_shards)
    if w < 1:
        raise ValueError(f"stage width must be >= 1, got {w}")
    if m < 1:
        raise ValueError(f"model_shards must be >= 1, got {m}")
    w_local = -(-w // m)
    return w_local, m * w_local


def stage_column_slices(param, t0, w_local: int, w_global: int, device=None) -> torch.Tensor:
    """The (model shard, stage) column slices of a cascade-ordered param
    array -> a ``(M, S, w_local, *param.shape[1:])`` tensor on ``device``
    (the tensor's own device when ``param`` is one, else the CPU) with

        ``out[j, s, c] = param[t0[s] + j * w_local + c]``

    and zeros where the index runs past ``T``.  ``param`` (numpy or torch)
    has its column axis first; ``t0[s]`` is stage s's first column.  Its
    dtype is kept."""
    t0 = np.asarray(t0, dtype=np.int64).reshape(-1)
    if w_global % max(w_local, 1) != 0:
        raise ValueError(f"w_global ({w_global}) must be a multiple of w_local ({w_local})")
    m = w_global // w_local
    s = len(t0)
    if not isinstance(param, torch.Tensor):
        param = torch.from_numpy(np.ascontiguousarray(param))
    dev = param.device if device is None else torch.device(device)
    param = param.to(dev)
    t_pad = (int(t0.max()) if s else 0) + w_global
    pad = t_pad - param.shape[0]
    if pad > 0:
        zeros = torch.zeros((pad, *param.shape[1:]), dtype=param.dtype, device=dev)
        param = torch.cat([param, zeros])
    idx = (
        t0[None, :, None]
        + (np.arange(m) * w_local)[:, None, None]
        + np.arange(w_local)[None, None, :]
    )
    out = param[torch.from_numpy(idx.reshape(-1)).to(dev)]
    return out.reshape(m, s, w_local, *param.shape[1:])


def model_stacked_shards(tree: dict, mesh) -> list[dict]:
    """The counterpart of ``model_stacked_shardings``: a dict of stacked
    ``(M, S, w_local, ...)`` slices (``stage_column_slices``) -> one dict a
    model shard, shard j's ``(S, w_local, ...)`` slice of every entry as a
    contiguous tensor on ``mesh.device``.  An empty dict (a scorer whose
    slab is the operand itself) gives M empty dicts."""
    m = int(mesh.shape.get("model", 1))
    for name, v in tree.items():
        if v.shape[0] != m:
            raise ValueError(
                f"model slice {name!r} has {v.shape[0]} shards, the mesh's 'model' axis {m}"
            )
    return [
        {name: v[j].to(mesh.device).contiguous() for name, v in tree.items()}
        for j in range(m)
    ]
