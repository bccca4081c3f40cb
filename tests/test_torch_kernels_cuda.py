"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the reference package, so it also runs on
the GPU machine (``python -m pytest -q tests/test_torch_kernels_cuda.py``).
Without a CUDA device every test skips: a CUDA kernel has no CPU mode.
Tolerances: 2e-3 in f32, 3e-2 in bf16 (the reference's parity bounds).
"""
import pytest
import torch

import repro_torch
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention import decode_attention as da

TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # the plain version's f32 products must not drop to TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, dtype, lengths, *, h, kh, d, blk, seed=0):
    """Random pools, disjoint shuffled block tables, and one zero-length
    padding row on the garbage page 0 (the last row)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    nb_per = [-(-n // blk) for n in lengths]
    m, total = max(nb_per), sum(nb_per)
    nb = total + 4
    q = torch.randn(len(lengths) + 1, h, d, generator=g)
    kp = torch.randn(nb, blk, kh, d, generator=g)
    vp = torch.randn(nb, blk, kh, d, generator=g)
    ids = torch.randperm(nb - 1, generator=g)[:total] + 1
    bt = torch.zeros(len(lengths) + 1, m, dtype=torch.int32)
    off = 0
    for r, n in enumerate(nb_per):
        bt[r, :n] = ids[off:off + n]
        off += n
    lens = torch.tensor(list(lengths) + [0], dtype=torch.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            bt.to(device), lens.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,d", [(32, 4, 128), (32, 8, 64), (4, 2, 16),
                                    (48, 8, 128), (32, 1, 64)])
def test_kernel_matches_plain(cuda_device, dtype, h, kh, d):
    """Ragged lengths around page edges and past 2k, at depths 1, 2 and
    the solved one; the padding row is finite."""
    args = _problem(cuda_device, dtype, [1, 15, 16, 17, 300, 2048], h=h,
                    kh=kh, d=d, blk=16)
    ref = da.paged_flash_decode_plain(*args).float()
    for depth in (1, 2, None):
        out = da.paged_flash_decode(*args, depth=depth).float()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[:-1], ref[:-1], rtol=TOL[dtype],
                                   atol=TOL[dtype])
    assert launch_counts()["paged_decode"] == 3


@pytest.mark.parametrize("blk", [4, 8, 32])
def test_kernel_page_sizes(cuda_device, blk):
    args = _problem(cuda_device, torch.float32, [3, 40, 129], h=8, kh=2, d=64,
                    blk=blk, seed=blk)
    out = da.paged_flash_decode(*args)
    ref = da.paged_flash_decode_plain(*args)
    torch.testing.assert_close(out[:-1], ref[:-1], rtol=2e-3, atol=2e-3)


def test_kernel_raises_instead_of_falling_back(cuda_device):
    q, kp, vp, bt, lens = _problem(cuda_device, torch.float32, [5, 9], h=4,
                                   kh=2, d=16, blk=8)
    with pytest.raises(TypeError):          # no f16 kernel
        da.paged_flash_decode(q.half(), kp.half(), vp.half(), bt, lens)
    with pytest.raises(ValueError):         # head_dim 32 not built
        da.paged_flash_decode(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                              vp[..., :8].contiguous(), bt, lens)
    with pytest.raises(ValueError):         # mixed devices
        da.paged_flash_decode(q, kp.cpu(), vp, bt, lens)
    strided = torch.cat([kp, kp], dim=-1)[..., ::2]
    assert strided.shape == kp.shape and not strided.is_contiguous()
    with pytest.raises(ValueError):         # non-contiguous pool
        da.paged_flash_decode(q, strided, vp, bt, lens)
    assert launch_counts()["paged_decode"] == 0
