"""Checkpoints of the flow network, read for both sides of the comparison.

A frozen copy of the program's reader: flax's msgpack file (maps, strings,
binaries, numbers, nil, booleans, and arrays as ext type 1 whose payload is
msgpack of [shape, dtype name, raw C-order bytes]) decoded without msgpack
or flax, and the parameter tree laid out as the program's state dict
('module.layer.weight' / '.bias'; convolution kernels OIHW, transposed
convolutions flipped in space and laid out (in, out, kh, kw)). The harness
loads the tensors once and hands the same ones to the program and to the
reference.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Mapping

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


def load(path: str, device) -> Dict[str, torch.Tensor]:
    """The checkpoint at `path` as a float32 state dict on `device`."""
    return {k: v.to(device) for k, v in params_from_jax(load_params(path)).items()}
