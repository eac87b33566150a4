"""LZW compression (Janus §IV-A: intermediate activations are LZW-compressed
before device->cloud transfer; the Cloud-Only baseline LZW-compresses frames).

Pure-python LZW with 16-bit codes and dictionary reset at 65536 entries —
control-plane code (runs on host CPU over the *pruned* intermediate tensor,
which is small); deliberately NOT a TPU kernel (DESIGN.md §2: entropy coding
has no MXU analogue).

``activation_payload`` optionally int8-quantizes the activation first (scale =
max-abs per tensor), which is both what makes LZW effective on float data and a
standard serving-tier transport optimization; the engine accounts accuracy via
the pruning AccuracyModel, and the quantization round-trip error is covered by
tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MAX_DICT = 65536


def lzw_compress(data: bytes) -> np.ndarray:
    """Returns uint16 code array."""
    table: dict[bytes, int] = {bytes([i]): i for i in range(256)}
    nxt = 256
    w = b""
    out: list[int] = []
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
        else:
            out.append(table[w])
            if nxt < _MAX_DICT:
                table[wc] = nxt
                nxt += 1
            else:
                table = {bytes([i]): i for i in range(256)}
                nxt = 256
            w = bytes([ch])
    if w:
        out.append(table[w])
    return np.asarray(out, dtype=np.uint16)


def lzw_decompress(codes: np.ndarray) -> bytes:
    table: dict[int, bytes] = {i: bytes([i]) for i in range(256)}
    nxt = 256
    it = iter(np.asarray(codes, dtype=np.uint16).tolist())
    try:
        prev = table[next(it)]
    except StopIteration:
        return b""
    out = [prev]
    for code in it:
        if code in table:
            entry = table[code]
        elif code == nxt:
            entry = prev + prev[:1]
        else:
            raise ValueError(f"bad LZW code {code}")
        out.append(entry)
        if nxt < _MAX_DICT:
            table[nxt] = prev + entry[:1]
            nxt += 1
        else:
            table = {i: bytes([i]) for i in range(256)}
            nxt = 256
        prev = entry
    return b"".join(out)


@dataclasses.dataclass(frozen=True)
class Payload:
    codes: np.ndarray | None  # None => stored raw (compression would expand)
    raw: bytes | None
    scale: float
    shape: tuple[int, ...]
    quantized: bool

    @property
    def nbytes(self) -> int:
        if self.codes is not None:
            return int(self.codes.nbytes)
        return len(self.raw)

    def ratio(self) -> float:
        raw = int(np.prod(self.shape)) * (1 if self.quantized else 4)
        return self.nbytes / max(raw, 1)


def activation_payload(x, quantize: bool = True) -> Payload:
    """Quantize (optional) + LZW; falls back to storing raw bytes whenever LZW
    would *expand* the payload (entropy coding loses on high-entropy data —
    a real transport sends raw in that case).

    ``x`` may be a tensor on any device: it is brought to the host in f32
    (``.numpy()`` rejects bf16), which is what ``np.asarray`` of a bf16 JAX
    array promotes to in the quantize arithmetic below."""
    arr = x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    shape = arr.shape
    if quantize:
        scale = float(np.max(np.abs(arr))) or 1.0
        q = np.clip(np.round(arr / scale * 127.0), -127, 127).astype(np.int8)
        raw = q.tobytes()
    else:
        scale = 1.0
        raw = arr.astype(np.float32).tobytes()
    codes = lzw_compress(raw)
    if codes.nbytes >= len(raw):
        return Payload(None, raw, scale, shape, quantize)
    return Payload(codes, None, scale, shape, quantize)


def decode_activation(p: Payload, dtype=np.float32) -> np.ndarray:
    raw = lzw_decompress(p.codes) if p.codes is not None else p.raw
    if p.quantized:
        q = np.frombuffer(raw, dtype=np.int8).reshape(p.shape)
        return (q.astype(dtype) / 127.0 * p.scale)
    return np.frombuffer(raw, dtype=np.float32).reshape(p.shape).astype(dtype)
