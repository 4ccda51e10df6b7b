"""Graceful preemption (counterpart of `mm_unet_tpu/utils/preempt.py`).

A SIGTERM or SIGINT flips a flag; the epoch loop reads it at step
boundaries, saves a `checkpoint` the resume path understands and returns 0,
and a restart with `trainer.resume: true` continues from the saved epoch.
"""

from __future__ import annotations

import signal


class GracefulShutdown:
    """Latches SIGTERM/SIGINT into a poll-able flag.

    First signal: request a clean shutdown (finish the current step, save,
    exit). Second SIGINT: restore the previous handler and raise
    KeyboardInterrupt, so an unresponsive run can still be stopped. Handlers
    can only be installed from the main thread.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signals = signals
        self._previous = {}

    def install(self) -> "GracefulShutdown":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            signal.signal(signal.SIGINT, self._previous.get(signal.SIGINT))
            raise KeyboardInterrupt
        self.requested = True
        print(
            f"[preempt] received signal {signum}: finishing current step, "
            "saving checkpoint, exiting",
            flush=True,
        )

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
