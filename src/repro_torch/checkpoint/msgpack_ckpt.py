"""Checkpoints in the reference's files (``repro.checkpoint.msgpack_ckpt``),
read and written both ways.

A checkpoint is a directory ``step_{step:08d}`` holding one raw
``leaf_{i:05d}.bin`` a leaf (its bytes in C order) and ``manifest.msgpack``,
a map from each leaf's ``/``-joined key path (dict key, sequence index) to
``{index, shape, dtype}``.  Leaves are numbered in JAX's flatten order
(``repro_torch.tree``: dict keys sorted).  A bf16 leaf is written with
dtype ``"bfloat16"``, as the reference's ``np.asarray`` names it, and read
back through ``torch.frombuffer``.

The manifest is msgpack.  The port carries its own encoder and decoder
for the subset a manifest uses (maps, str, non-negative ints, arrays),
byte for byte what ``msgpack.packb`` writes for it; anything else is
refused.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Any

import torch

from repro_torch.tree import flatten, path_key, tree_map_with_path

__all__ = ["latest_step", "pack", "restore_checkpoint", "save_checkpoint", "unpack"]

_SHARDED_TODO = "shardings needs the sharded executors, not ported yet (ROADMAP A15)"

# torch dtype <-> the dtype string of the reference's manifest
_DTYPES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}


# -- msgpack, the manifest's subset ----------------------------------------------


def pack(obj) -> bytes:
    """msgpack encoding of maps, lists, str and non-negative ints, in the
    smallest form, as ``msgpack.packb`` (``use_bin_type=True``) writes."""
    out = bytearray()

    def put(o):
        if isinstance(o, bool) or o is None:
            raise TypeError(f"the manifest encoder does not take {o!r}")
        if isinstance(o, int):
            if o < 0:
                raise TypeError(f"the manifest encoder takes non-negative ints, got {o}")
            if o < 0x80:
                out.append(o)
            elif o <= 0xFF:
                out.extend(b"\xcc" + struct.pack(">B", o))
            elif o <= 0xFFFF:
                out.extend(b"\xcd" + struct.pack(">H", o))
            elif o <= 0xFFFFFFFF:
                out.extend(b"\xce" + struct.pack(">I", o))
            elif o <= 0xFFFFFFFFFFFFFFFF:
                out.extend(b"\xcf" + struct.pack(">Q", o))
            else:
                raise TypeError(f"int {o} does not fit msgpack's uint64")
        elif isinstance(o, str):
            b = o.encode("utf-8")
            n = len(b)
            if n < 32:
                out.append(0xA0 | n)
            elif n <= 0xFF:
                out.extend(b"\xd9" + struct.pack(">B", n))
            elif n <= 0xFFFF:
                out.extend(b"\xda" + struct.pack(">H", n))
            else:
                out.extend(b"\xdb" + struct.pack(">I", n))
            out.extend(b)
        elif isinstance(o, (list, tuple)):
            _head(out, len(o), 0x90, b"\xdc", b"\xdd")
            for v in o:
                put(v)
        elif isinstance(o, dict):
            _head(out, len(o), 0x80, b"\xde", b"\xdf")
            for k, v in o.items():
                put(k)
                put(v)
        else:
            raise TypeError(f"the manifest encoder does not take {type(o).__name__}")

    put(obj)
    return bytes(out)


def _head(out: bytearray, n: int, fix: int, b16: bytes, b32: bytes) -> None:
    if n < 16:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.extend(b16 + struct.pack(">H", n))
    else:
        out.extend(b32 + struct.pack(">I", n))


def unpack(data: bytes):
    """Decode what ``pack`` (or ``msgpack.packb`` on the same subset)
    wrote; any other msgpack type is refused."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated msgpack manifest")
        b = data[pos:pos + n]
        pos += n
        return b

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def get():
        t = take(1)[0]
        if t < 0x80:
            return t
        if 0x80 <= t <= 0x8F:
            return mapping(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [get() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return take(t & 0x1F).decode("utf-8")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if t in ints:
            return num(ints[t])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return take(num(strs[t])).decode("utf-8")
        if t in (0xDC, 0xDD):
            return [get() for _ in range(num(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return mapping(num(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack type 0x{t:02x} is not in the manifest's subset")

    def mapping(n):
        out = {}
        for _ in range(n):
            k = get()
            out[k] = get()
        return out

    obj = get()
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the msgpack manifest")
    return obj


# -- checkpoints -----------------------------------------------------------------


def _items(tree) -> list[tuple[str, torch.Tensor]]:
    return [(path_key(path), leaf) for path, leaf in flatten(tree)]


def save_checkpoint(ckpt_dir, step: int, tree: Any) -> pathlib.Path:
    """Write ``tree``'s leaves (tensors on any device) and its manifest
    into ``ckpt_dir/step_{step:08d}``; returns that directory."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for i, (key, leaf) in enumerate(_items(tree)):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        if t.dtype not in _DTYPES:
            raise TypeError(f"leaf {key!r}: dtype {t.dtype} has no checkpoint name")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        (d / f"leaf_{i:05d}.bin").write_bytes(raw.numpy().tobytes())
        manifest[key] = {"index": i, "shape": list(t.shape), "dtype": _DTYPES[t.dtype]}
    (d / "manifest.msgpack").write_bytes(pack(manifest))
    return d


def latest_step(ckpt_dir) -> int | None:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: int, target: Any, shardings: Any | None = None,
                       device="cuda") -> Any:
    """The checkpoint's leaves in the structure of ``target`` (a tree of
    tensors, matched by key path), on ``device``, each in its saved dtype
    and shape."""
    if shardings is not None:
        raise ValueError(_SHARDED_TODO)
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = unpack((d / "manifest.msgpack").read_bytes())

    def load(path, _leaf):
        meta = manifest[path_key(path)]
        raw = bytearray((d / f"leaf_{meta['index']:05d}.bin").read_bytes())
        if meta["dtype"] not in _FROM_NAME:
            raise TypeError(f"checkpoint dtype {meta['dtype']!r} is not supported")
        dt = _FROM_NAME[meta["dtype"]]
        t = torch.frombuffer(raw, dtype=dt) if raw else torch.empty(0, dtype=dt)
        return t.reshape(meta["shape"]).to(device)

    return tree_map_with_path(load, target)
