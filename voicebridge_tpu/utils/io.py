"""Keyed array store: the framework's "data plane".

Replaces the reference's ark/scp table system
(``util/kaldi-table.h:233-433``, ``util/kaldi-io.h:124-190``): utterance-keyed
matrices (features, alignments, stats) streamed between pipeline stages.

Design: one ``.npz``-like directory store per archive — a single
memory-mappable ``data.npy`` blob plus a JSON index of ``key -> (offset rows,
shape)``.  All matrices in one archive share a dtype and trailing dims; this is
exactly what batched device consumption wants (contiguous, sliceable, mmap-able)
and what the reference's per-utterance ark records are not.

Also provides ``KeyedText`` for text tables (utt2spk, text, wav.scp).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Mapping, Sequence

import numpy as np


class ArrayArchive:
    """Read side of an utterance-keyed array archive (``feats/`` dir).

    With ``compression="uint8"`` at write time, rows are stored as per-key,
    per-column affine-quantized uint8 codes (the role of Kaldi's
    ``CompressedMatrix``, ``matrix/compressed-matrix.h``: lossy feature
    storage at 4x reduction); decompression is transparent on read.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path / "index.json") as f:
            index = json.load(f)
        self.dtype = np.dtype(index["dtype"])
        self.trailing = tuple(index["trailing"])  # shape after first axis
        self.compression = index.get("compression")
        self._index: dict[str, tuple[int, int]] = {
            k: (v[0], v[1]) for k, v in index["keys"].items()
        }
        self._data = np.load(self.path / "data.npy", mmap_mode="r")
        if self.compression == "uint8":
            # [K, 2, *trailing]: per-key column (offset, scale)
            self._qparams = np.load(self.path / "qparams.npy", mmap_mode="r")
            self._ordinal = {k: i for i, k in enumerate(self._index)}

    def keys(self) -> list[str]:
        return list(self._index.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, key: str) -> np.ndarray:
        off, n = self._index[key]
        raw = np.asarray(self._data[off : off + n])
        if self.compression == "uint8":
            lo, scale = np.asarray(self._qparams[self._ordinal[key]])
            return (raw.astype(self.dtype) * scale + lo).astype(self.dtype)
        return raw

    def num_rows(self, key: str) -> int:
        return self._index[key][1]

    def items(self) -> Iterator[tuple[str, np.ndarray]]:
        for k in self._index:
            yield k, self[k]


class ArrayArchiveWriter:
    """Write side. Rows are appended; ``close()`` finalizes data + index."""

    def __init__(self, path: str | Path, dtype=np.float32,
                 compression: str | None = None):
        if compression not in (None, "uint8"):
            raise ValueError(f"unknown compression {compression!r}")
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.dtype = np.dtype(dtype)
        self.compression = compression
        self._chunks: list[np.ndarray] = []
        self._qparams: list[np.ndarray] = []
        self._keys: dict[str, tuple[int, int]] = {}
        self._offset = 0
        self._trailing: tuple | None = None

    def write(self, key: str, array: np.ndarray) -> None:
        if key in self._keys:
            raise KeyError(f"duplicate key {key!r}")
        arr = np.asarray(array, dtype=self.dtype)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        trailing = arr.shape[1:]
        if self._trailing is None:
            self._trailing = trailing
        elif trailing != self._trailing:
            raise ValueError(
                f"inconsistent trailing shape {trailing} vs {self._trailing}"
            )
        self._keys[key] = (self._offset, arr.shape[0])
        self._offset += arr.shape[0]
        if self.compression == "uint8":
            # per-column affine quantization over this key's rows
            lo = arr.min(axis=0) if arr.shape[0] else np.zeros(trailing, self.dtype)
            hi = arr.max(axis=0) if arr.shape[0] else np.zeros(trailing, self.dtype)
            scale = np.maximum((hi - lo) / 255.0, 1e-20).astype(self.dtype)
            codes = np.clip(np.rint((arr - lo) / scale), 0, 255).astype(np.uint8)
            self._qparams.append(np.stack([lo.astype(self.dtype), scale]))
            self._chunks.append(codes)
        else:
            self._chunks.append(arr)

    def close(self) -> ArrayArchive:
        trailing = self._trailing if self._trailing is not None else ()
        store_dtype = np.uint8 if self.compression == "uint8" else self.dtype
        data = (
            np.concatenate(self._chunks, axis=0)
            if self._chunks
            else np.zeros((0, *trailing), dtype=store_dtype)
        )
        np.save(self.path / "data.npy", data)
        if self.compression == "uint8":
            q = (np.stack(self._qparams) if self._qparams
                 else np.zeros((0, 2, *trailing), self.dtype))
            np.save(self.path / "qparams.npy", q)
        with open(self.path / "index.json", "w") as f:
            json.dump(
                {
                    "dtype": self.dtype.str,
                    "trailing": list(trailing),
                    "compression": self.compression,
                    "keys": {k: [o, n] for k, (o, n) in self._keys.items()},
                },
                f,
            )
        return ArrayArchive(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


def write_archive(path: str | Path, items: Mapping[str, np.ndarray] | Sequence[tuple[str, np.ndarray]], dtype=np.float32, compression: str | None = None) -> ArrayArchive:
    w = ArrayArchiveWriter(path, dtype=dtype, compression=compression)
    it = items.items() if isinstance(items, Mapping) else items
    for k, v in it:
        w.write(k, v)
    return w.close()


# ---------------------------------------------------------------------------
# Text tables (wav.scp / text / utt2spk / spk2utt style files)
# ---------------------------------------------------------------------------


def read_keyed_text(path: str | Path) -> dict[str, list[str]]:
    """Read ``key val1 val2 ...`` lines into an ordered dict."""
    out: dict[str, list[str]] = {}
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        parts = line.split()
        if not parts:
            continue
        key = parts[0]
        if key in out:
            raise ValueError(f"duplicate key {key!r} in {path}")
        out[key] = parts[1:]
    return out


def write_keyed_text(path: str | Path, table: Mapping[str, Sequence[str] | str]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for key in sorted(table):
            val = table[key]
            if isinstance(val, str):
                f.write(f"{key} {val}\n")
            else:
                f.write(f"{key} {' '.join(str(v) for v in val)}\n")


def utt2spk_to_spk2utt(utt2spk: Mapping[str, str]) -> dict[str, list[str]]:
    """Invert utt->spk (reference: ``utt2spk_to_spk2utt.cpp``)."""
    spk2utt: dict[str, list[str]] = {}
    for utt in sorted(utt2spk):
        spk2utt.setdefault(utt2spk[utt], []).append(utt)
    return spk2utt
