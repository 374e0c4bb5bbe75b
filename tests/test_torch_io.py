"""Port parity: the file layer (kaldi_tpu_torch/io/) against kaldi_tpu/io/
on the CPU.

- wave and HTK files written by either package are the same bytes, and
  each package reads the other's files to bit-equal arrays (RIFX too);
- binary, text and compressed arks of float and double matrices and
  vectors and int vectors: the same bytes both ways, bit-equal arrays
  read back by either package, scp indexes with the same offsets,
  `ark,scp:` / `ark,t:` wspecifiers, `scp:` and piped `ark:cmd |`
  rspecifiers;
- the port's native reader (its own build of native/ark_io.cc) agrees
  with its Python reader and with JAX's, the native writer's arks read
  back in both packages, and a mixed ark falls back without duplicates;
- the native library builds atomically into an empty build directory
  under concurrent first use, and a failed build is not remembered.
"""

import gzip
import io
import os
import shutil
import struct
import threading

import numpy as np
import pytest

from kaldi_tpu.io import compressed as jcomp
from kaldi_tpu.io import htk as jhtk
from kaldi_tpu.io import kaldi_io as jkio
from kaldi_tpu.io import wave as jwave
from kaldi_tpu_torch.io import compressed as tcomp
from kaldi_tpu_torch.io import htk as thtk
from kaldi_tpu_torch.io import kaldi_io as tkio
from kaldi_tpu_torch.io import native as tnative
from kaldi_tpu_torch.io import wave as twave

PKGS = {"jax": (jwave, jhtk, jkio), "port": (twave, thtk, tkio)}


def _items(seed: int = 0) -> list:
    rng = np.random.RandomState(seed)
    return [("fm", rng.randn(7, 5).astype(np.float32)),
            ("dm", rng.randn(4, 3)),
            ("fv", rng.randn(9).astype(np.float32)),
            ("dv", rng.randn(6)),
            ("ali", rng.randint(0, 50, 11).astype(np.int32)),
            ("fm2", rng.randn(30, 13).astype(np.float32) * 10)]


def _float_items(seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    return [(f"u{i}", rng.randn(rng.randint(5, 40), 6).astype(np.float32))
            for i in range(5)] + [("v", rng.randn(8).astype(np.float32))]


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same_items(got, want):
    assert [k for k, _v in got] == [k for k, _v in want]
    for (_k, a), (_k2, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, _k
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [1, 2])
def test_wave_files_cross(channels, tmp_path):
    rng = np.random.RandomState(channels)
    data = (rng.randn(channels, 3001) * 9000).astype(np.float32)
    paths = {}
    for name, (wave, _h, _k) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.wav")
        wave.write_wave(paths[name], data if channels > 1 else data[0],
                        16000.0)
    assert _read_bytes(paths["jax"]) == _read_bytes(paths["port"])
    for path in paths.values():
        (dj, sj), (dt, st) = jwave.read_wave(path), twave.read_wave(path)
        assert sj == st == 16000.0 and dt.dtype == dj.dtype
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(dt, np.clip(np.round(data), -32768,
                                                  32767))


def test_rifx_wave_reads_alike():
    pcm = (np.arange(-40, 40) * 400).astype(">i2").tobytes()
    head = struct.pack(">4sI4s4sIHHIIHH4sI", b"RIFX", 36 + len(pcm),
                       b"WAVE", b"fmt ", 16, 1, 1, 8000, 16000, 2, 16,
                       b"data", len(pcm))
    (dj, sj), (dt, st) = (mod.read_wave(head + pcm) for mod in (jwave,
                                                               twave))
    assert sj == st == 8000.0
    np.testing.assert_array_equal(dt, dj)
    with pytest.raises(ValueError):
        twave.read_wave(b"RIFF\x00\x00\x00\x00JUNK")


def test_htk_files_cross(tmp_path):
    feats = np.random.RandomState(3).randn(12, 7).astype(np.float32)
    paths = {}
    for name, (_w, htk, _k) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.htk")
        htk.write_htk(paths[name], feats, samp_period=50000, parm_kind=6)
    assert _read_bytes(paths["jax"]) == _read_bytes(paths["port"])
    (fj, hj), (ft, ht) = jhtk.read_htk(paths["port"]), thtk.read_htk(
        paths["jax"])
    assert hj == ht
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ft, feats)


MODES = {"binary": dict(binary=True), "text": dict(binary=False),
         "compressed": dict(compress=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_ark_files_cross(mode, tmp_path):
    items = _items() if mode != "compressed" else [
        (k, v) for k, v in _items() if v.ndim == 2] + [
        ("edge", np.zeros((3, 0), np.float32)),
        ("one", np.array([[1.5, -2.0, 7.0]], np.float32))]
    if mode == "text":     # text objects read back as float32 / int32
        items = [(k, v) for k, v in items if v.dtype != np.float64]
    paths = {}
    for name, (_w, _h, kio) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.ark")
        kio.write_ark(paths[name], items, **MODES[mode])
    assert _read_bytes(paths["jax"]) == _read_bytes(paths["port"])
    for path in paths.values():
        # by path (plain binary arks take the native reader, which reads
        # DM / DV as float32 in both packages) and through a file handle
        # (the Python reader)
        _same_items(list(tkio.read_ark(path)), list(jkio.read_ark(path)))
        with open(path, "rb") as f, open(path, "rb") as g:
            _same_items(list(tkio.read_ark(f)), list(jkio.read_ark(g)))


def test_compressed_matrix_equals_jax():
    rng = np.random.RandomState(5)
    for rows in (1, 2, 4, 5, 9, 64):
        m = (rng.randn(rows, 6) * rng.uniform(0.1, 50)).astype(np.float32)
        cj, ct = jcomp.CompressedMatrix.compress(m), \
            tcomp.CompressedMatrix.compress(m)
        assert (ct.global_min, ct.global_range, ct.shape, ct.nbytes) == \
            (cj.global_min, cj.global_range, cj.shape, cj.nbytes)
        np.testing.assert_array_equal(ct.col_headers, cj.col_headers)
        np.testing.assert_array_equal(ct.data, cj.data)
        np.testing.assert_array_equal(ct.decompress(), cj.decompress())
    with pytest.raises(ValueError):
        tcomp.CompressedMatrix.compress(np.zeros((0, 3), np.float32))


def test_scp_and_wspecifiers_cross(tmp_path):
    items = _items(7)
    out = {}
    for name, (_w, _h, kio) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        ark, scp = str(d / "a.ark"), str(d / "a.scp")
        kio.write_ark(ark, items, scp_path=scp)
        with kio.open_wspecifier(f"ark,scp:{d / 'b.ark'},{d / 'b.scp'}") \
                as w:
            for k, v in items:
                w.write(k, v)
        with kio.open_wspecifier(f"ark,t:{d / 't.ark'}") as w:
            for k, v in items:
                if v.dtype != np.float64:
                    w.write(k, v)
        out[name] = d
    for f in ("a.ark", "b.ark", "t.ark"):
        assert _read_bytes(out["jax"] / f) == _read_bytes(out["port"] / f)
    for f in ("a.scp", "b.scp"):
        lines = [open(out[n] / f).read().replace(str(out[n]), "")
                 for n in ("jax", "port")]
        assert lines[0] == lines[1]
    for d in out.values():
        for f in ("a.scp", "b.scp"):
            want = list(jkio.open_rspecifier(f"scp:{d / f}"))
            _same_items(list(tkio.open_rspecifier(f"scp:{d / f}")), want)
            _same_items(list(tkio.read_scp(str(d / f))), want)
        _same_items(list(tkio.open_rspecifier(f"ark,t:{d / 't.ark'}")),
                    list(jkio.open_rspecifier(f"ark,t:{d / 't.ark'}")))


def test_piped_specifiers_cross(tmp_path):
    ark = str(tmp_path / "a.ark")
    jkio.write_ark(ark, _items(8))
    spec = f"ark:cat {ark} |"
    _same_items(list(tkio.open_rspecifier(spec)),
                list(jkio.open_rspecifier(spec)))
    gz = str(tmp_path / "b.ark.gz")
    buf = io.BytesIO()
    tkio.write_ark(buf, _items(9))
    with gzip.open(gz, "wb") as f:
        f.write(buf.getvalue())
    _same_items(list(tkio.open_rspecifier(f"ark:gunzip -c {gz} |")),
                list(jkio.open_rspecifier(f"ark:gunzip -c {gz} |")))
    with pytest.raises(ValueError):
        tkio.open_rspecifier(f"bad:{ark}")
    with pytest.raises(ValueError):
        tkio.open_rxfilename("|gzip -c > x")


def test_file_offset_rxfilename(tmp_path):
    ark, scp = str(tmp_path / "a.ark"), str(tmp_path / "a.scp")
    tkio.write_ark(ark, _items(10), scp_path=scp)
    for line in open(scp):
        key, rx = line.split()
        f = tkio.open_rxfilename(rx)
        try:
            got = tkio.read_object(f)
        finally:
            f.close()
        g = jkio.open_rxfilename(rx)
        try:
            np.testing.assert_array_equal(got, jkio.read_object(g))
        finally:
            g.close()


def test_native_reader_agrees_with_python_and_jax(tmp_path):
    assert tnative.available()
    ark = str(tmp_path / "a.ark")
    items = _float_items()
    tkio.write_ark(ark, items)
    native = list(tnative.read_ark_native(ark))
    with open(ark, "rb") as f:
        python = list(tkio.read_ark(f))
    _same_items(native, python)
    _same_items(native, list(jkio.read_ark(ark)))
    _same_items(list(tkio.read_ark(ark)), python)


def test_native_writer_reads_back_in_both_packages(tmp_path):
    ark, scp = str(tmp_path / "n.ark"), str(tmp_path / "n.scp")
    items = _float_items(2)
    with tnative.ArkWriterNative(ark, scp) as w:
        for k, v in items:
            w.write(k, v)
    py = str(tmp_path / "p.ark")
    tkio.write_ark(py, items)
    assert _read_bytes(ark) == _read_bytes(py)
    _same_items(list(jkio.read_ark(ark)), items)
    _same_items(list(tkio.read_scp(scp)), items)


def test_read_ark_dispatches_to_native(tmp_path, monkeypatch):
    ark = str(tmp_path / "a.ark")
    tkio.write_ark(ark, _float_items(3))
    calls = []
    real = tnative.read_ark_native

    def spy(path):
        calls.append(path)
        return real(path)
    monkeypatch.setattr(tnative, "read_ark_native", spy)
    assert len(list(tkio.read_ark(ark))) == 6 and calls == [ark]
    calls.clear()
    tkio.write_ark(ark, _float_items(3), compress=True)   # CM: Python
    assert len(list(tkio.read_ark(ark))) == 6 and calls == []


def test_mixed_ark_falls_back_without_duplicates(tmp_path):
    ark = str(tmp_path / "m.ark")
    items = _float_items(4)
    with open(ark, "wb") as f:
        tkio.write_ark(f, items[:2])
        tkio.write_ark(f, items[2:3], compress=True)
        tkio.write_ark(f, items[3:])
    got, want = list(tkio.read_ark(ark)), list(jkio.read_ark(ark))
    _same_items(got, want)
    assert [k for k, _v in got] == [k for k, _v in items]


def _fresh_native(monkeypatch, root):
    monkeypatch.setattr(tnative, "BUILD_ROOT", str(root))
    monkeypatch.setattr(tnative, "_lib", None)


def test_native_builds_atomically_into_an_empty_directory(tmp_path,
                                                          monkeypatch):
    root = tmp_path / "build"
    _fresh_native(monkeypatch, root)
    libs, errors = [], []

    def first_use():
        try:
            libs.append(tnative.load())
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(libs) == 4 and len({id(x) for x in libs}) == 1
    so = tnative.library_path()
    assert so.startswith(str(root))
    # only the finished library is left: no temporary file
    assert os.listdir(os.path.dirname(so)) == [os.path.basename(so)]
    ark = str(tmp_path / "a.ark")
    tkio.write_ark(ark, _float_items(5))
    _same_items(list(tnative.read_ark_native(ark)), _float_items(5))


def test_failed_native_build_is_not_latched(tmp_path, monkeypatch):
    _fresh_native(monkeypatch, tmp_path / "build")
    real_which = shutil.which
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="g.. not found"):
        tnative.load()
    ark = str(tmp_path / "a.ark")
    tkio.write_ark(ark, _float_items(6))
    _same_items(list(tkio.read_ark(ark)), _float_items(6))  # Python path
    monkeypatch.setattr(tnative.shutil, "which", real_which)
    assert tnative.available()
    assert os.path.exists(tnative.library_path())


def test_write_object_text_int_and_binary_bytes_equal():
    for value in (np.arange(5, dtype=np.int64), [3, 1, 4],
                  np.float32(2.5) * np.ones((2, 2), np.float32)):
        for binary in (True, False):
            bj, bt = io.BytesIO(), io.BytesIO()
            jkio.write_object(bj, value, binary=binary)
            tkio.write_object(bt, value, binary=binary)
            assert bj.getvalue() == bt.getvalue()
            bt.seek(0)
            np.testing.assert_array_equal(
                tkio.read_object(bt), jkio.read_object(io.BytesIO(
                    bj.getvalue())))
