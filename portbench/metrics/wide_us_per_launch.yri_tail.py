"""Device microseconds of the bf16 window kernel's wide variant a launch
(csrc/window_clr.cu, window_clr_kernel_wide: 128 < R <= 256 rows): its
device time in the trace over the launches the window made, which the
program counts in ops/window_clr.py:window_clr_wide_launches.  The
counter is read as the harness loads this reader, just before the
window, and again after it; a program without the counter or the kernel
gives nothing."""

UNIT = "us"
KERNEL = ("window_clr_kernel_wide",)


def _launches():
    try:
        from fscl_tpu_torch.ops import window_clr
    except ImportError:
        return None
    return getattr(window_clr, "window_clr_wide_launches", None)


_AT_LOAD = _launches()


def read(r):
    now = _launches()
    if now is None or _AT_LOAD is None or now <= _AT_LOAD:
        return None
    dev = r.trace.device_s(KERNEL)
    if dev <= 0:
        return None
    return 1e6 * dev / (now - _AT_LOAD)
