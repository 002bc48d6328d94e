"""The port's hand-written kernels against their plain versions.

This file imports neither JAX nor the reference, so it also runs on the
machine with the card (whose Python has no JAX), without the suite's
conftest: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
Tests marked ``cuda`` need the card and skip without one.
"""

import numpy as np
import pytest
import torch

from protocol_tpu_torch.ops import kernels
from protocol_tpu_torch.ops.kernels import lane_perm, lane_perm_plain

_DTYPES = (np.float32, np.float64, np.int32)


def _case(T, np_dtype, seed):
    rng = np.random.default_rng(seed)
    if np_dtype == np.int32:
        x = rng.integers(-2**31, 2**31 - 1, (T, 128), dtype=np.int32)
    else:
        x = rng.standard_normal((T, 128)).astype(np_dtype)
    idx = rng.integers(0, 128, (T, 128)).astype(np.uint8)
    return x, idx


@pytest.mark.parametrize("T", [1, 7, 8, 1000])
def test_lane_perm_on_cpu_is_the_plain_gather(T):
    for np_dtype in _DTYPES:
        x, idx = _case(T, np_dtype, T)
        before = kernels.LAUNCHES["lane_perm"]
        y = lane_perm(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
        assert kernels.LAUNCHES["lane_perm"] == before  # no kernel on CPU
        assert np.array_equal(
            y, np.take_along_axis(x, idx.astype(np.int64), axis=1))


def test_lane_perm_rejects_bad_input():
    x = torch.zeros(4, 128)
    idx = torch.zeros(4, 128, dtype=torch.uint8)
    with pytest.raises(ValueError):
        lane_perm(torch.zeros(4, 64), idx[:, :64])
    with pytest.raises(ValueError):
        lane_perm(x, idx.long())
    with pytest.raises(ValueError):
        lane_perm(x, idx[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 7, 8, 1000, 8192])
def test_lane_perm_kernel_matches_plain(T):
    """The CUDA kernel, bit-exact against its plain version on the card
    (float32, float64, int32; T below, at and past one tile, with a
    ragged last tile at 1000), and one count per launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for np_dtype in _DTYPES:
        x, idx = _case(T, np_dtype, T)
        x, idx = torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()
        before = kernels.LAUNCHES["lane_perm"]
        y = lane_perm(x, idx)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["lane_perm"] == before + 1
        assert torch.equal(y, lane_perm_plain(x, idx))


@pytest.mark.cuda
def test_lane_perm_kernel_takes_unaligned_views():
    """A view that starts off a 16-byte boundary is copied, not refused
    and not sent to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, idx = _case(9, np.float32, 3)
    xf = torch.from_numpy(x).cuda().view(-1)
    x2 = torch.cat([xf[:1], xf])[1:].view(9, 128)  # storage offset 4 bytes
    assert x2.data_ptr() % 16 != 0
    idx = torch.from_numpy(idx).cuda()
    before = kernels.LAUNCHES["lane_perm"]
    y = lane_perm(x2, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lane_perm"] == before + 1
    assert torch.equal(y, lane_perm_plain(x2, idx))
