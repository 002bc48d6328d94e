"""Lane-sharded attestation ingest over a device mesh: the counterpart
of ``protocol_tpu/parallel/ingest.py``.

The ingest's device stages — the lift/scalar prep and the GLV +
fixed-base-window recovery ladder (``ops.secp_batch``) — are
embarrassingly parallel along the attestation lane axis: no cross-lane
state, no collectives. Each shard runs the single-device stage
(``_recover_prep``, ``_recover_glv``) on its contiguous lane slice, on
its own device, so B2, ``add_mod`` and ``sub_mod`` launch per shard;
the host orchestration (limb prep, the Babai GLV split between the two
stages, the final unpack) is ``recover_batch``'s own, through its
``_prep``/``_glv`` stage hooks. The outputs are bit-identical to the
single-device path.

The reference shards the prep stage alone on XLA:CPU by default
(``PTPU_SHARD_GLV``), because there the sharded ladder is a compile of
minutes; nothing compiles here, so both stages always shard
(``shard_glv=None`` means True).
"""

from __future__ import annotations

import numpy as np

from ..ops import secp_batch as sb
from .mesh import Mesh, shard, unshard


def _sharded_stage(fn, mesh: Mesh):
    """``fn`` (a lane-wise stage of ``ops.secp_batch``) run shard by
    shard: every array argument is split on its lane axis over the mesh,
    every result is gathered back in lane order on shard 0's device."""

    def run(*args):
        parts = [shard(a, mesh) for a in args]
        outs = [fn(*(p[d] for p in parts)) for d in range(mesh.size)]
        return tuple(unshard([o[i] for o in outs])
                     for i in range(len(outs[0])))

    return run


def _check_lanes(k: int, mesh: Mesh, axis: str | None) -> None:
    axis = axis or mesh.axis_names[0]
    if k % mesh.size:
        raise ValueError(
            f"{k} lanes do not divide over the {mesh.size}-way "
            f"'{axis}' axis; pad to a multiple (client.ingest's pow-2 "
            "buckets already do)")


def sharded_prep_parity(rs, ss, rec_ids, msgs, mesh: Mesh,
                        axis: str | None = None):
    """Run the lift/scalar-prep stage BOTH ways — single-device (on
    shard 0's device) and lane-sharded — and return
    ``(single, sharded, range_ok)`` where the first two are tuples of
    host arrays (r_m, y_sel, lift_ok, u1, u2)."""
    _check_lanes(len(rs), mesh, axis)
    dev = mesh.devices[0]
    single = sb.recover_submit(rs, ss, rec_ids, msgs, device=dev)
    sharded = sb.recover_submit(rs, ss, rec_ids, msgs, device=dev,
                                _prep=_sharded_stage(sb._recover_prep, mesh))
    # range_ok is host-computed from the raw (r, s) identically on both
    # calls — return it once
    return (tuple(a.cpu().numpy() for a in single[1]),
            tuple(a.cpu().numpy() for a in sharded[1]),
            np.asarray(single[2]))


def sharded_recover_batch(rs, ss, rec_ids, msgs, mesh: Mesh,
                          axis: str | None = None,
                          shard_glv: bool | None = None):
    """``ops.secp_batch.recover_batch`` with the device stages sharded
    over ``mesh``'s lane axis — same host orchestration, same outputs
    (bit-identical). The lane count must divide the mesh.
    ``shard_glv=False`` runs the ladder on shard 0's device alone."""
    _check_lanes(len(rs), mesh, axis)
    prep = _sharded_stage(sb._recover_prep, mesh)
    glv = (None if shard_glv is False
           else _sharded_stage(sb._recover_glv, mesh))
    return sb.recover_batch(rs, ss, rec_ids, msgs, device=mesh.devices[0],
                            _prep=prep, _glv=glv)
