"""Kernels written by hand for Hopper, each beside its plain version.

- ``lane_perm`` (CUDA, ``csrc/lane_perm.cu``): one Clos routing stage,
  replacing ``protocol_tpu/ops/clos.py::_lane_perm_pallas``.
"""

from .lane_perm_kernel import LAUNCHES, lane_perm, lane_perm_plain, reset_launches

__all__ = ["LAUNCHES", "lane_perm", "lane_perm_plain", "reset_launches"]
