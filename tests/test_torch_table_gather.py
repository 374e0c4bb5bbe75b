"""Port parity: the table gather's plain version against the Pallas kernel.

`batched_table_gather_ref` (what the wrapper takes for CPU tensors) is held
bit-exact against kaldi_tpu's `_pallas_gather` in interpret mode and
against kaldi_tpu's dispatcher. The CUDA kernel itself is checked on the
card (tests/test_torch_cuda.py and chip_smoke.py's kernel phase).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.ops.table_gather import (_pallas_gather,
                                        batched_table_gather as j_gather)
from kaldi_tpu_torch.ops import table_gather as tg

torch.set_num_threads(2)


def _case(B, P, N, seed=0):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((B, P)).astype(np.float32)
    idx = rng.integers(0, P, (B, N)).astype(np.int32)
    return tab, idx


def _pallas(tab, idx):
    """kaldi_tpu's kernel in interpret mode, padded as its dispatcher pads."""
    B, P = tab.shape
    N = idx.shape[1]
    P128 = -(-P // 128) * 128
    Npad = -(-N // 1024) * 1024
    tp = np.pad(tab, ((0, 0), (0, P128 - P)))
    ip = np.pad(idx, ((0, 0), (0, Npad - N)))
    return np.asarray(_pallas_gather(jnp.asarray(tp), jnp.asarray(ip),
                                     interpret=True))[:, :N]


@pytest.mark.parametrize("P", [64, 200, 2048, 7000, 16384])
def test_plain_version_bit_exact_vs_pallas(P):
    tab, idx = _case(2, P, 1500, seed=P)      # N not a multiple of 1024
    got = tg.batched_table_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), _pallas(tab, idx))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_gather(jnp.asarray(tab), jnp.asarray(idx))))


def test_out_of_range_gives_zero_like_pallas():
    tab = np.arange(1, 201, dtype=np.float32).reshape(2, 100)
    idx = np.array([[-1, 0, 99, 100, 127], [5, 128, -7, 3, 99]], np.int32)
    got = tg.batched_table_gather_ref(torch.from_numpy(tab),
                                      torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(
        got, [[0, 1, 100, 0, 0], [106, 0, 0, 104, 200]])
    # indices in [0, 128) match the padded Pallas table exactly
    ok = (idx >= 0) & (idx < 128)
    np.testing.assert_array_equal(got[ok], _pallas(tab, np.where(ok, idx, 0))
                                  [ok])


def test_kernel_path_refuses_cpu_tensors():
    tab, idx = _case(2, 64, 10)
    with pytest.raises(ValueError, match="CUDA"):
        tg.gather_cuda(torch.from_numpy(tab), torch.from_numpy(idx))
    assert tg.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_kernel_path_validates_inputs(bad):
    tab = torch.zeros(2, 64)
    idx = torch.zeros(2, 10, dtype=torch.int32)
    if bad == "dtype":
        idx = idx.long()
    elif bad == "shape":
        idx = idx[:1]
    else:
        tab = torch.zeros(64, 2).T
    # these checks come before the device check
    with pytest.raises(ValueError, match={"dtype": "int32", "shape": "shapes",
                                          "contiguous": "contiguous"}[bad]):
        tg.gather_cuda(tab, idx)


def test_module_imports_without_nvcc_or_triton():
    code = ("import sys, shutil; sys.modules['triton'] = None; "
            "shutil.which = lambda *a, **k: None; "
            "import kaldi_tpu_torch.ops.table_gather as t; "
            "from kaldi_tpu_torch import cuda_build; "
            "assert not cuda_build._fns and t.launches == 0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(__import__('pathlib').Path(
                           __file__).resolve().parents[1]))
    assert r.returncode == 0, r.stderr

