"""Kernels written by hand for Hopper, each beside its plain version.

- ``route_stage`` (CUDA, ``csrc/lane_perm.cu``): one Clos route stage,
  transpose included, replacing ``protocol_tpu/ops/clos.py::_lane_perm_pallas``
  and the transposes around it, for one vector or a topic batch
  ``[K, T, 128]`` in one launch; ``lane_perm`` is its middle form.
- ``field_kernel`` (CUDA, ``csrc/field.cu``): the Montgomery multiply
  and the modular add and subtract.
"""

from .lane_perm_kernel import (
    FORWARD,
    LAUNCHES,
    MIDDLE,
    REVERSE,
    lane_perm,
    lane_perm_plain,
    reset_launches,
    route_stage,
    route_stage_plain,
)

__all__ = ["FORWARD", "LAUNCHES", "MIDDLE", "REVERSE", "lane_perm",
           "lane_perm_plain", "reset_launches", "route_stage",
           "route_stage_plain"]
