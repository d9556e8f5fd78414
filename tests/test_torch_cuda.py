"""The port's CUDA kernels against their plain versions, on a CUDA device.

Marked ``cuda``; each test skips on a host without a CUDA device. This file
imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from harl_tpu_torch.ops import gae_kernels as K

pytestmark = pytest.mark.cuda

# both float32; nvcc fuses multiply-adds that the plain version rounds twice
RTOL = ATOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(T, trailing, with_bad, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn((T,) + trailing, generator=g)
    v = torch.randn((T + 1,) + trailing, generator=g)
    m = (torch.rand((T + 1,) + trailing, generator=g) > 0.15).float()
    b = (torch.rand((T + 1,) + trailing, generator=g) > 0.1).float() if with_bad else None
    return [None if x is None else x.to(device) for x in (r, v, m, b)]


SHAPES = [(9, (7, 1)), (9, (4, 3, 1)), (9, (130, 1)), (32, (4096, 1)), (9, (5000, 1))]


@pytest.mark.parametrize("T,trailing", SHAPES)
@pytest.mark.parametrize("with_bad", [True, False])
def test_gae_kernel_matches_plain(device, T, trailing, with_bad):
    r, v, m, b = _problem(T, trailing, with_bad, device)
    before = K.gae.launches
    out = K.gae(r, v, m, b, 0.99, 0.95)
    torch.cuda.synchronize()
    assert K.gae.launches == before + 1
    torch.testing.assert_close(out, K.gae_reference(r, v, m, b, 0.99, 0.95),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,trailing", SHAPES)
@pytest.mark.parametrize("with_bad", [True, False])
def test_returns_kernel_matches_plain(device, T, trailing, with_bad):
    r, v, m, b = _problem(T, trailing, with_bad, device, seed=1)
    nv = v[-1].contiguous()
    before = K.discounted_returns.launches
    out = K.discounted_returns(r, v, m, b, nv, 0.99)
    torch.cuda.synchronize()
    assert K.discounted_returns.launches == before + 1
    torch.testing.assert_close(out, K.discounted_returns_reference(r, v, m, b, nv, 0.99),
                               rtol=RTOL, atol=ATOL)


def test_kernel_refuses_mixed_devices(device):
    r, v, m, b = _problem(4, (3, 1), True, device)
    with pytest.raises(ValueError):
        K.gae(r, v.cpu(), m, b, 0.99, 0.95)
