"""Preemption-safe shutdown: SIGTERM/SIGINT -> drain -> emergency save.

Counterpart of ``paddle_tpu/robustness/preemption.py``, kept as the
port's own copy; the fleet router polls the same flag for its preempt
drain (``FleetRouter(preemption=...)``).

Cloud preemption is a SIGTERM with a grace window; a training loop
with up to `async_window` steps in flight must NOT checkpoint from the
signal handler (the scope may be mid-update and most of the runtime is
not async-signal-safe). The handler here only sets a flag; a training
loop polls it between dispatches, drains, writes an emergency
checkpoint through the normal atomic path, and returns cleanly. The chaos tier requests preemption through the same
flag, so both paths are one code path.
"""

import signal
import threading

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Install with `install()` (or use as a context manager); poll
    `requested()` from the training loop. Re-entrant signals are
    harmless (the flag is already set); a second SIGINT restores the
    previous handler so a stuck drain can still be interrupted."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._old = {}
        self._installed = False

    # -- flag ----------------------------------------------------------
    def request(self, signum=None, frame=None):
        """The signal handler body: flag only, no I/O, no locks."""
        self._flag.set()
        if signum == signal.SIGINT and self._installed:
            # let a second ^C interrupt a wedged drain/save
            old = self._old.get(signal.SIGINT)
            if old is not None:
                signal.signal(signal.SIGINT, old)

    def requested(self):
        return self._flag.is_set()

    def clear(self):
        self._flag.clear()

    # -- install -------------------------------------------------------
    def install(self):
        """Install on the main thread; a no-op elsewhere (python only
        delivers signals to the main thread anyway)."""
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.signals:
            self._old[sig] = signal.signal(sig, self.request)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
