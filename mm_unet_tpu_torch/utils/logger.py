"""Stdout/stderr tee to a log file (counterpart of
`mm_unet_tpu/utils/logger.py`)."""

from __future__ import annotations

import os
import sys
import time


class _Tee:
    def __init__(self, stream, fh):
        self.stream = stream
        self.fh = fh

    def write(self, data):
        self.stream.write(data)
        self.fh.write(data)

    def flush(self):
        self.stream.flush()
        self.fh.flush()


class Logger:
    """Tees stdout/stderr to `logs/<name><timestamp>/log.txt` until `close`.

    It writes through to the streams it found, and `close` puts those back,
    so entry points called one after another in one process nest cleanly."""

    def __init__(self, name: str, root: str = "logs"):
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        self.dir = os.path.join(root, f"{name}{stamp}")
        os.makedirs(self.dir, exist_ok=True)
        self.fh = open(os.path.join(self.dir, "log.txt"), "a")
        self._streams = (sys.stdout, sys.stderr)
        self._tees = (_Tee(sys.stdout, self.fh), _Tee(sys.stderr, self.fh))
        sys.stdout, sys.stderr = self._tees

    def close(self):
        if self.fh.closed:
            return
        self._tees[0].flush()
        self._tees[1].flush()
        # put back what was there, unless a later tee replaced ours
        if sys.stdout is self._tees[0]:
            sys.stdout = self._streams[0]
        if sys.stderr is self._tees[1]:
            sys.stderr = self._streams[1]
        self.fh.close()
