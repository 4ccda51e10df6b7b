"""Scalar tracker: a JSONL event stream per run directory (counterpart of
`mm_unet_tpu/utils/tracker.py`, the same files for the same scalars).

`ScalarTracker` appends one JSON object per event to `scalars.jsonl` in the
run's log directory, with `step`, the wall-clock `time` and the scalars;
`read_scalars` reads a stream back, and `tb_export` writes it as a
TensorBoard events file (simple values only) without tensorboard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class ScalarTracker:
    """Append-only JSONL scalar logger.

    >>> tr = ScalarTracker("logs/run1")
    >>> tr.log({"Train/loss": 0.5}, step=10)
    """

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", buffering=1)  # line-buffered

    def log(self, scalars: Mapping[str, float], step: int) -> None:
        event = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                event[k] = float(v)
            except (TypeError, ValueError):
                event[k] = v
        self._fh.write(json.dumps(event) + "\n")

    def close(self) -> None:
        self._fh.close()


def read_scalars(path: str) -> list[dict]:
    """Load a scalars.jsonl stream back into a list of event dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def tb_export(jsonl_path: str, out_dir: str) -> str:
    """Convert a scalars.jsonl stream to a TensorBoard events file.

    Writes the minimal TFRecord/Event encoding (simple values only) without a
    tensorboard/tensorflow dependency; returns the events file path.
    """
    import struct
    import zlib

    def _masked_crc(data: bytes) -> int:
        crc = zlib.crc32(data) & 0xFFFFFFFF
        return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    def _varint(n: int) -> bytes:
        out = b""
        while True:
            b7 = n & 0x7F
            n >>= 7
            if n:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def _field(num: int, wire: int) -> bytes:
        return _varint((num << 3) | wire)

    def _event(step: int, wall: float, tag: str, value: float) -> bytes:
        # summary.value { tag, simple_value }
        tag_b = tag.encode()
        val = _field(1, 2) + _varint(len(tag_b)) + tag_b
        val += _field(2, 5) + struct.pack("<f", float(value))
        summ = _field(1, 2) + _varint(len(val)) + val
        ev = _field(1, 1) + struct.pack("<d", wall)  # wall_time (double)
        ev += _field(2, 0) + _varint(step)  # step
        ev += _field(5, 2) + _varint(len(summ)) + summ  # summary
        return ev

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"events.out.tfevents.{int(time.time())}.mmunet")
    with open(out_path, "wb") as fh:
        for event in read_scalars(jsonl_path):
            step, wall = event.get("step", 0), event.get("time", 0.0)
            for k, v in event.items():
                if k in ("step", "time") or not isinstance(v, (int, float)):
                    continue
                rec = _event(step, wall, k, v)
                hdr = struct.pack("<Q", len(rec))
                fh.write(hdr + struct.pack("<I", _masked_crc(hdr)))
                fh.write(rec + struct.pack("<I", _masked_crc(rec)))
    return out_path
