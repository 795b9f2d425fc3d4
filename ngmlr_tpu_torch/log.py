"""Console logging — the reference's `_Log` subsystem
(ngmlr src/Logging.cpp, ILog.h:40-60, unix.cpp:36-59).

Reproduced behaviors:

  * levels: message(0) / warning(1) / error(2) / green(3) / progress(99),
  * ``--color``: the exact ANSI palette of unix.cpp:36 — message "0",
    warning "0;33", error "0;31", green "0;32" — with a reset after each
    line (Logging.cpp:94-102),
  * progress lines rewind: the next console write erases the previous
    progress line with ESC[A ESC[2K (rwl(), Logging.cpp:73-77),
  * more than 100 warnings abort the run with the reference's exact
    notice (Logging.cpp:211-216) and exit code 1,
  * error() terminates with "Terminating" (Logging.cpp:218-229),
  * ``--verbose`` enables verbose() output (the reference's pacbioDebug /
    Log.Verbose stream is compiled out in release builds; here it is a
    runtime switch).

Thread-safe like the original (one mutex around console writes).
"""

import sys
import threading

_COLORS = {0: "0", 1: "0;33", 2: "0;31", 3: "0;32"}  # unix.cpp:36


class _Log:
    def __init__(self):
        self.color = False
        self.verbose_enabled = False
        self.stream = None          # None = sys.stderr at call time
        self._warning_count = 0
        self._rewind = 0
        self._lock = threading.Lock()

    def configure(self, color: bool = False, verbose: bool = False,
                  stream=None):
        self.color = color
        self.verbose_enabled = verbose
        self.stream = stream
        self._warning_count = 0
        self._rewind = 0

    # -- internals -------------------------------------------------------

    def _emit(self, lvl: int, msg: str, progress: bool = False):
        """Console write; caller holds the lock."""
        out = []
        if self._rewind:
            out.append("\033[A\033[2K" * self._rewind)
            self._rewind = 0
        if self.color:
            out.append("\033[%sm" % _COLORS.get(lvl, "0"))
        out.append(msg)
        if self.color:
            out.append("\033[0m")
        out.append("\n")
        (self.stream or sys.stderr).write("".join(out))
        if progress:
            self._rewind = 1

    def _write(self, lvl: int, msg: str, progress: bool = False):
        with self._lock:
            self._emit(lvl, msg, progress)

    # -- public levels (ILog.h:44-48) ------------------------------------

    def message(self, msg: str, *args):
        self._write(0, msg % args if args else msg)

    def warning(self, msg: str, *args):
        # counter + cap check under the same mutex as the write: warnings
        # arrive from worker threads, and the cap notice must respect any
        # pending progress-line rewind (Logging.cpp:200-216)
        with self._lock:
            self._emit(1, msg % args if args else msg)
            self._warning_count += 1
            terminate = self._warning_count > 100
            if terminate:
                (self.stream or sys.stderr).write(
                    "Max number of warnings reached!\nPlease report this "
                    "issue on http://github.com/Cibiv/NextGenMap/issues!\n")
        if terminate:
            raise SystemExit(1)

    def error(self, msg: str, *args):
        self._write(2, msg % args if args else msg)
        (self.stream or sys.stderr).write("Terminating\n")
        raise SystemExit(1)

    def green(self, msg: str, *args):
        self._write(3, msg % args if args else msg)

    def progress(self, msg: str, *args):
        self._write(0, msg % args if args else msg, progress=True)

    def verbose(self, msg: str, *args):
        if self.verbose_enabled:
            self._write(0, msg % args if args else msg)


Log = _Log()
