"""Host utilities: leveled logging (a copy of fscl_tpu/utils/logging.py)."""
