"""Host utilities: leveled logging (a copy of fscl_tpu/utils/logging.py)
and phase timers and the drivers' spans (utils/timing.py, on
torch.profiler's clock)."""
