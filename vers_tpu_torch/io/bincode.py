"""Minimal bincode-1.3 codec (legacy defaults) for index persistence.

The reference serializes every index with ``bincode::serialize_into`` /
``deserialize_from`` using bincode 1.3.3 defaults
(`vers/src/indexes/base.rs:31-58`, `vers/Cargo.toml:9`):

- little-endian, **fixed-width** integer encoding,
- ``usize`` encoded as u64,
- ``Vec<T>`` / ``HashMap<K, V>`` / ``String``: u64 element count then
  elements (pairs for maps),
- ``[f32; N]`` via serde_arrays: serialized as a tuple — N raw LE f32,
  **no** length prefix,
- enums: u32 variant index then payload,
- structs/tuples: fields in declaration order, no framing.

This module implements exactly that subset so our files load in the
Rust reference and vice versa.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

import numpy as np


class Writer:
    def __init__(self, fp: BinaryIO):
        self._fp = fp

    def u32(self, v: int) -> None:
        self._fp.write(struct.pack("<I", v))

    def u64(self, v: int) -> None:
        self._fp.write(struct.pack("<Q", v))

    def f32(self, v: float) -> None:
        self._fp.write(struct.pack("<f", float(v)))

    def f32_array(self, arr) -> None:
        """serde_arrays [f32; N]: raw LE floats, no length prefix."""
        a = np.ascontiguousarray(np.asarray(arr, dtype="<f4"))
        self._fp.write(a.tobytes())

    def vec_u64(self, vals) -> None:
        a = np.ascontiguousarray(np.asarray(vals, dtype="<u8"))
        self.u64(a.size)
        self._fp.write(a.tobytes())

    def vec_f32_matrix(self, mat) -> None:
        """Vec<Vector<N>>: u64 count then count×N raw f32."""
        m = np.ascontiguousarray(np.asarray(mat, dtype="<f4"))
        if m.ndim != 2:
            raise ValueError(f"expected 2D matrix, got {m.shape}")
        self.u64(m.shape[0])
        self._fp.write(m.tobytes())

    def string(self, s: str) -> None:
        b = s.encode("utf-8")
        self.u64(len(b))
        self._fp.write(b)


class Reader:
    def __init__(self, fp: BinaryIO):
        self._fp = fp

    def _read(self, n: int) -> bytes:
        if n < 0 or n > (1 << 40):
            raise ValueError(
                f"implausible read of {n} bytes — corrupt file or wrong dim?"
            )
        b = self._fp.read(n)
        if len(b) != n:
            raise EOFError(
                f"expected {n} bytes, got {len(b)} — corrupt file or wrong dim?"
            )
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self._read(4))[0]

    def f32_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(4 * n), dtype="<f4").copy()

    def vec_u64(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self._read(8 * n), dtype="<u8").copy()

    def vec_f32_matrix(self, dim: int) -> np.ndarray:
        n = self.u64()
        data = np.frombuffer(self._read(4 * n * dim), dtype="<f4").copy()
        return data.reshape(n, dim)

    def string(self) -> str:
        n = self.u64()
        return self._read(n).decode("utf-8")

    def at_eof(self) -> bool:
        pos = self._fp.tell()
        b = self._fp.read(1)
        if b:
            self._fp.seek(pos)
            return False
        return True


def dumps(write_fn) -> bytes:
    buf = io.BytesIO()
    write_fn(Writer(buf))
    return buf.getvalue()
