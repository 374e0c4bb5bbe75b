"""Port parity: int8 weight-only serving against kaldi_tpu/nnet/quantized.py.

Quantization is numpy in both packages, so the int8 codes and scales are
held equal array for array. `qaffine_ref` (what the wrapper takes for CPU
tensors) is held at atol 1e-4 to the Pallas kernel in interpret mode and
to the XLA route, as tests/test_quantized.py holds those two to each
other: the kernel scales the f32 accumulator while the XLA route folds the
scale into the weights first, so the two differ by rounding. The same
bound holds `QuantizedTdnn` to `tdnn_apply_quantized`. The CUDA kernel
itself is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_tpu.nnet import quantized as jq
from kaldi_tpu.nnet.tdnn import Tdnn as JTdnn, TdnnConfig as JTdnnConfig
from kaldi_tpu_torch.nnet import quantized as tq
from kaldi_tpu_torch.nnet.tdnn import TdnnConfig
from kaldi_tpu_torch.params import random_tdnn_params, tdnn_qparams_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "relu": dict(feat_dim=12, num_pdfs=24, hidden_dim=32,
                 pnorm_output_dim=8, nonlinearity="relu"),
    "pnorm": dict(feat_dim=12, num_pdfs=24, hidden_dim=32,
                  pnorm_output_dim=8, nonlinearity="pnorm"),
}


def _case(M, K, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((N, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wq, sc = tq.quantize_weights(w)
    return x, wq, sc, b


def _ref(x, wq, sc, b):
    return tq.qaffine(*(torch.from_numpy(a) for a in (x, wq, sc, b))).numpy()


def test_quantize_weights_equal_jax_codes():
    w = np.random.default_rng(0).standard_normal((16, 40)).astype(np.float32)
    # exact halves after scaling (scale 1): round half to even
    w[0, :4] = [127.0, 63.5, -2.5, 0.5]
    for got, want in zip(tq.quantize_weights(w), jq.quantize_weights(w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tq.quantize_weights(w)[0][0, :4].tolist() == [127, 64, -2, 0]


@pytest.mark.parametrize("name", ["relu", "pnorm"])
def test_quantize_tdnn_equal_jax(name):
    params = random_tdnn_params(TdnnConfig(**CONFIGS[name]),
                                np.random.default_rng(1))
    got, want = tq.quantize_tdnn(params), jq.quantize_tdnn(params)
    for g, w in zip(got["layers"] + [got["final"]],
                    want["layers"] + [want["final"]]):
        for k in ("wq", "scale", "b"):
            assert g[k].dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_plain_version_matches_pallas_interpret():
    x, wq, sc, b = _case(40, 128, 128, seed=2)   # the JAX test's shape
    want = np.asarray(jq.qaffine(jnp.asarray(x), wq, sc, b, interpret=True))
    np.testing.assert_allclose(_ref(x, wq, sc, b), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("M,K,N", [(1, 200, 130), (37, 72, 48),
                                   (20, 64, 48), (5, 33, 7)])
def test_plain_version_matches_xla_route(M, K, N):
    x, wq, sc, b = _case(M, K, N, seed=M + K + N)
    want = np.asarray(jq.qaffine(jnp.asarray(x), wq, sc, b, force_xla=True))
    got = _ref(x, wq, sc, b)
    assert got.shape == (M, N)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mag", [1e-3, 1e-1, 1.0, 37.0, 1e3, 1e4])
def test_split_bf16x3_is_exact(mag):
    rng = np.random.default_rng(int(mag * 1000) % 9973)
    x = (rng.standard_normal(4096) * mag).astype(np.float32)
    x[:4] = [0.0, -0.0, -mag, mag]
    x[4:8] = np.nextafter(np.float32(mag), np.float32(0)) * np.array(
        [1, -1, 3, -3], np.float32)
    xt = torch.from_numpy(x)
    planes = tq.split_bf16x3(xt)
    assert all(p.dtype == torch.bfloat16 for p in planes)
    total = sum(p.double() for p in planes)
    np.testing.assert_array_equal(total.numpy(), x.astype(np.float64))
    # every int8 code is a bf16 value: the kernel widens codes exactly
    codes = torch.arange(-127, 128, dtype=torch.int8)
    assert codes.numel() == 255
    assert torch.equal(codes.to(torch.bfloat16).to(torch.int8), codes)
    assert torch.equal(codes.to(torch.bfloat16).double(), codes.double())


@pytest.mark.parametrize("M,K,N", [(8, 200, 16), (6, 1024, 24),
                                   (5, 2048, 16), (3, 72, 130)])
def test_three_bf16_passes_match_jax(M, K, N):
    """The kernel's arithmetic on the CPU: three products of bf16-valued
    planes with the int8 codes, summed in f32, then scale and bias; held
    to both JAX routes as the plain version is."""
    rng = np.random.default_rng(M * K + N)
    w = rng.standard_normal((N, K)).astype(np.float32) / np.sqrt(K)
    wq, sc = tq.quantize_weights(w)
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    wf = torch.from_numpy(wq).float().T
    acc = sum(p.float() @ wf for p in tq.split_bf16x3(torch.from_numpy(x)))
    got = (acc * torch.from_numpy(sc) + torch.from_numpy(b)).numpy()
    xla = np.asarray(jq.qaffine(jnp.asarray(x), wq, sc, b, force_xla=True))
    pallas = np.asarray(jq.qaffine_pallas(jnp.asarray(x), jnp.asarray(wq.T),
                                          jnp.asarray(sc), jnp.asarray(b),
                                          interpret=True))
    np.testing.assert_allclose(got, xla, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=0)


@pytest.mark.parametrize("M,K,N", [(256, 16, 256), (512, 64, 512)])
def test_all_of_x_limit_needs_the_lo_pass(M, K, N):
    """The card test `test_qaffine_kernel_keeps_all_of_x` holds the kernel
    to 1e-6 of max|y| against f64 at these shapes. With exact sums, three
    passes land far inside that limit and two (no lo plane) outside it."""
    rng = np.random.default_rng(K)
    wq, sc = tq.quantize_weights(
        rng.standard_normal((N, K)).astype(np.float32) / np.sqrt(K))
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    w64 = wq.astype(np.float64).T
    want = (x.astype(np.float64) @ w64) * sc + b
    planes = [p.double().numpy() for p in tq.split_bf16x3(torch.from_numpy(x))]
    rel = {}
    for n in (2, 3):
        acc = (sum(planes[:n]) @ w64).astype(np.float32)
        rel[n] = np.abs(acc * sc + b - want).max() / np.abs(want).max()
    assert rel[3] <= 1e-6 / 4 and rel[2] >= 1e-6 * 1.5, rel


def test_wrapper_keeps_leading_dims():
    x, wq, sc, b = _case(24, 40, 16, seed=5)
    flat = _ref(x, wq, sc, b)
    got = tq.qaffine(torch.from_numpy(x).view(2, 3, 4, 40),
                     *(torch.from_numpy(a) for a in (wq, sc, b)))
    np.testing.assert_array_equal(got.numpy(), flat.reshape(2, 3, 4, 16))


@pytest.mark.parametrize("name", ["relu", "pnorm"])
@pytest.mark.parametrize("pad_context", [True, False])
def test_quantized_tdnn_matches_jax(name, pad_context):
    params = random_tdnn_params(TdnnConfig(**CONFIGS[name]),
                                np.random.default_rng(3))
    qtree = tq.quantize_tdnn(params)
    x = np.random.default_rng(4).standard_normal((2, 40, 12)) \
        .astype(np.float32)
    want = np.asarray(jq.tdnn_apply_quantized(
        JTdnn(JTdnnConfig(**CONFIGS[name])), qtree, jnp.asarray(x),
        pad_context=pad_context, force_xla=True))
    model = tq.QuantizedTdnn(TdnnConfig(**CONFIGS[name])).load_jax_qparams(
        qtree)
    with torch.no_grad():
        got = model(torch.from_numpy(x), pad_context=pad_context).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_qparams_converter_layout():
    cfg = TdnnConfig(**CONFIGS["pnorm"])
    qtree = tq.quantize_tdnn(random_tdnn_params(cfg, np.random.default_rng(6)))
    sd = tdnn_qparams_from_jax(qtree)
    assert sd["layers.0.wq"].dtype == torch.int8
    assert tuple(sd["layers.0.wq"].shape) == qtree["layers"][0]["wq"].shape
    model = tq.QuantizedTdnn(cfg).load_jax_qparams(qtree)
    np.testing.assert_array_equal(model.final.wq.numpy(),
                                  qtree["final"]["wq"])
    np.testing.assert_array_equal(model.layers[1].scale.numpy(),
                                  qtree["layers"][1]["scale"])


def test_quantized_tdnn_refuses_compute_dtype():
    model = tq.QuantizedTdnn(TdnnConfig(**CONFIGS["relu"]))
    with pytest.raises(ValueError, match="compute_dtype"):
        model(torch.zeros(1, 20, 12), compute_dtype=torch.bfloat16)


def test_kernel_path_refuses_cpu_tensors():
    x, wq, sc, b = (torch.from_numpy(a) for a in _case(8, 16, 8, seed=7))
    before = tq.launches
    with pytest.raises(ValueError, match="CUDA"):
        tq.qaffine_cuda(x, wq, sc, b)
    assert tq.launches == before


@pytest.mark.parametrize("bad", ["x_dtype", "wq_dtype", "scale_dtype", "k",
                                 "scale_shape", "x_rank", "contiguous"])
def test_kernel_path_validates_inputs(bad):
    x, wq, sc, b = (torch.from_numpy(a) for a in _case(8, 16, 8, seed=8))
    if bad == "x_dtype":
        x = x.double()
    elif bad == "wq_dtype":
        wq = wq.float()
    elif bad == "scale_dtype":
        sc = sc.half()
    elif bad == "k":
        x = x[:, :12]
    elif bad == "scale_shape":
        sc = sc[:4]
    elif bad == "x_rank":
        x = x[None]
    else:
        x = x.T.contiguous().T
    match = ("contiguous" if bad == "contiguous"
             else "dtype|takes f32" if "dtype" in bad else "shapes")
    with pytest.raises(ValueError, match=match):
        tq.qaffine_cuda(x, wq, sc, b)
    if bad != "contiguous":   # the plain version checks the same
        with pytest.raises(ValueError, match=match):
            tq.qaffine_ref(x, wq, sc, b)


def test_module_imports_without_nvcc():
    code = ("import sys, shutil; sys.modules['triton'] = None; "
            "shutil.which = lambda *a, **k: None; "
            "import kaldi_tpu_torch.nnet.quantized as q; "
            "from kaldi_tpu_torch import cuda_build; "
            "assert not cuda_build._fns and q.launches == 0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr
