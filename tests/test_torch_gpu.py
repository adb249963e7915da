"""CUDA-only tests of the port: each hand kernel against its plain torch
version on the card.  They carry the ``gpu`` marker and skip where no card
is present (decided inside the test, never at import).  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
torch:  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ngt_tpu_torch.ops import window_scan as WS

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rng, n, d, b, dev):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:b] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    ss = (x ** 2).sum(1).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(q).to(torch.bfloat16), t(x).to(torch.bfloat16), t(ss)


@pytest.mark.parametrize("n,d,b", [
    (65536, 128, 1024), (4096, 256, 100), (1024, 512, 64),
    (128 * 37, 128, 100), (128 * 37, 128, 4097), (128 * 37, 384, 300),
    (8192, 512, 257),
])
def test_window_scan_kernel_matches_plain(cuda, n, d, b):
    """Scores to rtol 1e-4 / atol 1e-3 and ids on >= 99.9% of entries (the
    tolerances of tests/test_pallas_scan.py; f32 sums in another order can
    swap near-tied rows of one window).  b = 100, 257, 300 and 4097 leave a
    ragged 128-query tile; 37 windows are not a whole 32-window run; d runs
    over 128, 256, 384 and 512 (the kernel's shared-memory plans)."""
    q16, x16, ss = _inputs(np.random.default_rng(7), n, d, b, cuda)
    wd, wi = WS.window_scan(q16, x16, ss)
    pd, pi = WS.window_scan_plain(q16, x16, ss)
    torch.cuda.synchronize()
    np.testing.assert_allclose(wd.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-3)
    assert (wi == pi).float().mean().item() >= 0.999


def test_window_scan_kernel_masks_invalid_rows(cuda):
    q16, x16, ss = _inputs(np.random.default_rng(3), 2048, 128, 64, cuda)
    ss[:128] = float(WS.BIG)   # a dead window
    ss[130] = float(WS.BIG)    # one dead row
    wd, wi = WS.window_scan(q16, x16, ss)
    assert (wd[:, 0] >= float(WS.BIG) * 0.5).all()
    assert (wi[:, 1] != 130).all()


def test_window_scan_kernel_rejects_wide_rows(cuda):
    q16, x16, ss = _inputs(np.random.default_rng(1), 1024, 640, 8, cuda)
    with pytest.raises(ValueError):
        WS.window_scan(q16, x16, ss)


def test_window_scan_kernel_duplicate_rows_take_the_lowest(cuda):
    """A window of identical rows ties exactly in every query: the id must
    be the window's first row, exactly, as the plain version gives it."""
    q16, x16, ss = _inputs(np.random.default_rng(5), 4096, 128, 300, cuda)
    x16[256:384] = x16[300].clone()
    ss[256:384] = ss[300].clone()
    x16[1024 + 7] = x16[1024 + 90]   # one tied pair inside a window
    ss[1024 + 7] = ss[1024 + 90]
    q16[:50] = x16[1024 + 90]        # queries that land on the pair
    wd, wi = WS.window_scan(q16, x16, ss)
    pd, pi = WS.window_scan_plain(q16, x16, ss)
    torch.cuda.synchronize()
    assert (wi[:, 2] == 256).all() and (pi[:, 2] == 256).all()
    assert (wi[:50, 8] == 1024 + 7).all() and (pi[:50, 8] == 1024 + 7).all()
    np.testing.assert_allclose(wd.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-3)


def test_window_scan_kernel_rejects_misaligned_pointers(cuda):
    """TMA reads 16-byte aligned tensors only: a contiguous view 2 bytes off
    a 16-byte boundary must raise, not launch."""
    n, d = 1024, 128
    q16, x16, ss = _inputs(np.random.default_rng(2), n, d, 64, cuda)
    off = torch.empty(n * d + 1, dtype=torch.bfloat16, device=cuda)[1:].view(n, d)
    off.copy_(x16)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned"):
        WS.window_scan(q16, off, ss)


def test_top_seeds_orders_ties_by_position_on_the_card(cuda):
    """torch.topk leaves the order of ties open on the card; top_seeds must
    take the lower position, as the reference's top-k does."""
    from ngt_tpu_torch.seeds import top_seeds

    rng = np.random.default_rng(4)
    scores = rng.integers(0, 6, size=(256, 4096)).astype(np.float32)
    got = top_seeds(torch.from_numpy(scores).to(cuda), 10).cpu().numpy()
    want = np.argsort(scores, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(got, want)
