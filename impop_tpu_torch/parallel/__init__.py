"""Batched window statistics (counterparts of :mod:`impop_tpu.parallel`):
the window and panel axes are batch dimensions of one device call."""
