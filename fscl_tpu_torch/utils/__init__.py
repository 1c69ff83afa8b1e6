"""Host utilities: leveled logging (a copy of fscl_tpu/utils/logging.py)
and phase timers (utils/timing.py, on torch.profiler)."""
