"""Card-only checks of the port: the table-gather kernel and the decoder on
a CUDA device. Each test skips without a card. This file imports no jax,
so it runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports jax, hence --noconftest there.)
"""

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.biggraph import BigGraphConfig, make_big_hclg
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu_torch.ops import table_gather as tg

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,P,N", [(8, 2048, 30384), (8, 7000, 4096),
                                   (3, 200, 1000), (2, 16384, 5000),
                                   (2, 20000, 3000), (4, 7000, 1),
                                   (1, 2048, 30384)])
def test_kernel_bit_exact(card, B, P, N):
    rng = np.random.default_rng(P + N)
    tab = torch.from_numpy(rng.standard_normal((B, P)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, P, (B, N)).astype(np.int32))
    t, i = tab.to(card), idx.to(card)
    before = tg.launches
    got = tg.batched_table_gather(t, i)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert torch.equal(got, torch.gather(t, 1, i.long()))
    assert torch.equal(got.cpu(), tg.batched_table_gather(tab, idx))


def test_kernel_out_of_range_is_zero(card):
    tab = torch.arange(1, 201, dtype=torch.float32, device=card).view(2, 100)
    idx = torch.tensor([[-1, 0, 99, 100], [5, 1000, -7, 3]],
                       dtype=torch.int32, device=card)
    assert tg.gather_cuda(tab, idx).tolist() == [[0, 1, 100, 0],
                                                 [106, 0, 0, 104]]


@pytest.mark.parametrize("kw", [dict(fold_eps=True), dict(fold_eps=False),
                                dict(hub_threshold=64)])
def test_decoder_card_equals_cpu(card, kw):
    g, _ = make_big_hclg(BigGraphConfig(vocab=300, avg_bigram_succ=20,
                                        num_pdfs=64, seed=1))
    opts = CsrBeamOpts(beam=9.0, max_active=256, acoustic_scale=0.1,
                       expand_budget=4096, eps_budget=1024, **kw)
    ll = (np.random.RandomState(3).randn(3, 40, 64) * 3).astype(np.float32)
    nf = np.array([40, 31, 17], np.int32)
    dg = CsrBeamDecoder(g, opts, device=card)
    dc = CsrBeamDecoder(g, opts, device="cpu")
    rg, rc = dg.decode(ll, nf), dc.decode(ll, nf)
    for b in range(3):
        assert rg[b][0] == rc[b][0] and rg[b][1] == rc[b][1]
        assert abs(rg[b][2] - rc[b][2]) < 1e-2
    for attr in ("last_overflow", "last_saturated", "last_active_sum",
                 "last_active_max"):
        np.testing.assert_array_equal(getattr(dg, attr), getattr(dc, attr))
