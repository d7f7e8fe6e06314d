"""Flow-network checkpoints of the JAX package, read and written without flax
or msgpack.

`load_params(path)` decodes the flax msgpack file with a small decoder of its
own (maps, strings, binaries, arrays, integers, floats, booleans, nil and
ext types) and returns the nested dict of numpy arrays that
`flax.serialization.msgpack_restore` would return. Flax writes every array
as ext type 1 whose payload is itself msgpack: `[shape, dtype name, raw
C-order bytes]`.

`params_from_jax(tree)` turns that nested dict (or the JAX package's own
parameters, converted leaf by leaf to numpy) into the port's state dict;
`params_to_jax(state_dict)` is its exact inverse, and `save_params(path,
tree)` writes the bytes `flax.serialization.to_bytes(tree)` would, so a
checkpoint trained by the port loads in the JAX package and in `load_params`.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1


class _Reader:
    """Minimal msgpack decoder over one bytes object."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: self.take(self.unpack(">B")),
            0xC5: lambda: self.take(self.unpack(">H")),
            0xC6: lambda: self.take(self.unpack(">I")),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.take(self.unpack(">B")).decode("utf-8"),
            0xDA: lambda: self.take(self.unpack(">H")).decode("utf-8"),
            0xDB: lambda: self.take(self.unpack(">I")).decode("utf-8"),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
        return simple[b]()

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, raw = _Reader(payload).obj()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_params(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays stored in a flax msgpack checkpoint."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} trailing bytes")
    return tree


def _pack_uint(n: int) -> bytes:
    if n <= 0x7F:
        return struct.pack(">B", n)
    for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I")):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_header(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...]) -> bytes:
    """Length header: a fix form (first byte | n) up to its limit, then the
    8-, 16- or 32-bit forms in `codes` (None where msgpack has no 8-bit form)."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, limit, fmt in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF), (">B", ">H", ">I")):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _pack_header(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw


def _pack_ndarray(arr: np.ndarray) -> bytes:
    """flax's ext type 1: msgpack of [shape, dtype name, raw C-order bytes]."""
    raw = arr.tobytes("C")
    payload = (
        b"\x93"
        + _pack_header(arr.ndim, (0x90, 15), (None, 0xDC, 0xDD))
        + b"".join(_pack_uint(int(d)) for d in arr.shape)
        + _pack_str(arr.dtype.name)
        + _pack_header(len(raw), None, (0xC4, 0xC5, 0xC6)) + raw
    )
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        head = bytes([fixext[len(payload)]])
    else:
        head = _pack_header(len(payload), None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", _EXT_NDARRAY) + payload


def _pack_tree(tree: Any) -> bytes:
    if isinstance(tree, Mapping):
        out = [_pack_header(len(tree), (0x80, 15), (None, 0xDE, 0xDF))]
        for k, v in tree.items():
            out.append(_pack_str(str(k)))
            out.append(_pack_tree(v))
        return b"".join(out)
    return _pack_ndarray(np.asarray(tree))


def save_params(path: str, tree: Mapping[str, Any]) -> None:
    """Write a nested dict of arrays (`params_to_jax`'s result) as the flax
    msgpack checkpoint `vstab.utils.checkpoint.save_params` writes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_pack_tree(tree))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest checkpoint by the step number embedded in `flow_NNNNNN.msgpack`
    (mtime breaks ties and orders free-form names), as
    `vstab.utils.checkpoint.latest_checkpoint` orders them."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [
        os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir) if f.endswith(".msgpack")
    ]
    if not cands:
        return None

    def key(p: str) -> Tuple[int, float]:
        m = re.search(r"(\d+)", os.path.basename(p))
        return (int(m.group(1)) if m else -1, os.path.getmtime(p))

    return max(cands, key=key)


# ConvTranspose layers: flax keeps (kh, kw, in, out) and does not flip the
# kernel; torch's conv_transpose2d takes (in, out, kh, kw) and flips it.
_TRANSPOSED = ("upflow", "upfeat")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree {'params': {module: {layer: {kernel, bias}}}} ->
    the port's state dict {'module.layer.weight' | '...bias': tensor}.

    Conv kernels HWIO -> OIHW; ConvTranspose kernels are flipped in space,
    then HWIO -> (in, out, kh, kw)."""
    sd: Dict[str, torch.Tensor] = {}
    for module, layers in tree["params"].items():
        for layer, leaves in layers.items():
            for leaf, value in leaves.items():
                arr = np.array(value, dtype=np.float32)  # a writable copy
                if leaf == "kernel":
                    t = torch.from_numpy(arr)
                    if layer in _TRANSPOSED:
                        t = t.flip(0, 1).permute(2, 3, 0, 1)
                    else:
                        t = t.permute(3, 2, 0, 1)
                    sd[f"{module}.{layer}.weight"] = t.contiguous()
                elif leaf == "bias":
                    sd[f"{module}.{layer}.bias"] = torch.from_numpy(arr)
                else:
                    raise ValueError(f"unexpected parameter {module}/{layer}/{leaf}")
    return sd


def params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The exact inverse of `params_from_jax`: the port's state dict -> the
    flax tree {'params': {module: {layer: {'kernel' | 'bias': f32 array}}}},
    conv kernels OIHW -> HWIO and the transposed convs' flip undone."""
    tree: Dict[str, Any] = {}
    for name, value in sd.items():
        module, layer, leaf = name.split(".")
        t = value.detach().to("cpu", torch.float32)
        if leaf == "weight":
            if layer in _TRANSPOSED:
                t = t.permute(2, 3, 0, 1).flip(0, 1)
            else:
                t = t.permute(2, 3, 1, 0)
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {name}")
        tree.setdefault(module, {}).setdefault(layer, {})[leaf] = np.ascontiguousarray(t.numpy())
    return {"params": tree}


__all__ = [
    "latest_checkpoint",
    "load_params",
    "params_from_jax",
    "params_to_jax",
    "save_params",
]
