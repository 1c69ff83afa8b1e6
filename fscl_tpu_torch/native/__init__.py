"""Native (C) host-side hot paths: the counterpart of ``fscl_tpu/native``.

``fastio`` builds ``fastio.c`` with the host's C compiler at first use;
where there is none, ``fastio.load()`` returns None and callers use their
Python loops.
"""
