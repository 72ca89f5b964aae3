"""Visualization tools (counterpart of deepim_tpu/toolkit/): the refinement videos."""
