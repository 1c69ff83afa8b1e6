"""Leveled logging mirroring the reference's logmsg subsystem.

Reference: logmsg.c (6 levels FATAL..DEBUG2, mutex-guarded
stderr, ``logmsg`` newline style vs ``cr_logmsg`` carriage-return progress
style; MSG_FATAL exits).  Re-designed on top of Python's threading lock; the
carriage-return progress style is kept because long scans want in-place
progress lines on a TTY.
"""

from __future__ import annotations

import sys
import threading

MSG_FATAL = 0
MSG_ERROR = 1
MSG_WARN = 2
MSG_STATUS = 3
MSG_DEBUG1 = 4
MSG_DEBUG2 = 5

_level = MSG_STATUS
_lock = threading.Lock()
_cr_active = False  # last write was a carriage-return progress line


class FatalError(SystemExit):
    """Raised (and exits) on MSG_FATAL, like logmsg.c:34."""


def configure_logmsg(level: int) -> None:
    global _level
    _level = max(int(level), 0)


def _emit(text: str, cr: bool) -> None:
    global _cr_active
    stream = sys.stderr
    with _lock:
        if cr and stream.isatty():
            stream.write("\r" + text)
            _cr_active = True
        else:
            if _cr_active and stream.isatty():
                stream.write("\n")
            _cr_active = False
            stream.write(text + ("\n" if not text.endswith("\n") else ""))
        stream.flush()


def logmsg(priority: int, fmt: str, *args) -> None:
    """Leveled message; priority MSG_FATAL exits the process."""
    text = (fmt % args) if args else fmt
    if priority <= _level:
        _emit(text, cr=False)
    if priority == MSG_FATAL:
        raise FatalError(f"FATAL: {text}")


def cr_logmsg(priority: int, fmt: str, *args) -> None:
    """In-place progress message (carriage-return style on a TTY)."""
    if priority > _level:
        return
    text = (fmt % args) if args else fmt
    _emit(text, cr=True)
