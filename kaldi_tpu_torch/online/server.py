"""TCP audio server: streaming decode over a socket.

Counterpart of kaldi_tpu/online/server.py (ref:
onlinebin/online-audio-server-decode-faster.cc + the legacy
online/online-tcp-source.h — clients stream raw 16-bit little-endian PCM;
the server runs the online decoder and writes partial hypotheses as they
change, then the final hypothesis when the client shuts down its writing
side). One thread per connection, each with its own session; the
sessions drive the port's `OnlineFeaturePipeline` / `OnlineDecoder` or
`FusedOnlineDecoder` on their decoder's device.

A connection's session must not share mutable decoder state with another
connection's: `fused_session_factory` gives each connection its own
`CsrBeamDecoder` (tier tables on the device) and `FusedOnlineDecoder`
over the shared AM and graph, builds the gather kernel before the first
connection arrives, and has the connections take turns on the device.
The AM is shared: its forward reads its weights only.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time

import numpy as np


def _pcm_samples(session, pcm: bytes):
    """Prepend the session's odd byte, keep a new one back (TCP reads have
    no 2-byte alignment) -> float samples at int16 scale, or None."""
    data = session._pcm_tail + pcm
    usable = len(data) - (len(data) % 2)
    session._pcm_tail = data[usable:]
    if usable == 0:
        return None
    return np.frombuffer(data[:usable], dtype="<i2").astype(np.float32)


def _words(res, words) -> str:
    if res is None:
        return ""
    return " ".join(words.sym(w) for w in res[0])


class DecodeSession:
    """Factory-produced per-connection state: a feature pipeline + online
    decoder + word-symbol mapper."""

    def __init__(self, make_pipeline, make_decoder, am, words,
                 chunk_samples: int = 4096):
        self.pipeline = make_pipeline()
        self.decoder = make_decoder()
        self.am = am
        self.words = words
        self._consumed = 0
        self._pcm_tail = b""   # TCP reads have no 2-byte alignment

    def accept_pcm(self, pcm: bytes):
        wave = _pcm_samples(self, pcm)
        if wave is None:
            return
        self.pipeline.accept_waveform(wave)
        self._advance()

    def _advance(self):
        feats = self.pipeline.get_features()
        if feats.shape[0] <= self._consumed:
            return
        new = feats[self._consumed:]
        ll = self.am.loglikes_np(new[None])[0]
        self.decoder.advance_decoding(ll)
        self._consumed = feats.shape[0]

    def finish(self):
        self.pipeline.input_finished()
        self._advance()

    def hypothesis(self, final: bool = False) -> str:
        return _words(self.decoder.best_path(use_final_probs=final),
                      self.words)


class FusedDecodeSession:
    """DecodeSession over the fused streaming decoder
    (kaldi_tpu/online/fused.py's port): the per-chunk pipeline on the
    decoder's device, one traceback copy per hypothesis query — the
    low-latency serving path for plain base-feature AMs.

    `turn`, a lock that sessions may share, is held around each call that
    drives the decoder: sessions that share one take turns (see
    `fused_session_factory`)."""

    def __init__(self, fused, words, turn: threading.Lock | None = None):
        self.fused = fused
        fused.reset()
        self.words = words
        self._pcm_tail = b""
        self._turn = turn or threading.Lock()

    def accept_pcm(self, pcm: bytes):
        wave = _pcm_samples(self, pcm)
        if wave is not None:
            with self._turn:
                self.fused.accept_waveform(wave)

    def finish(self):
        with self._turn:
            self.fused.input_finished()

    def hypothesis(self, final: bool = False) -> str:
        with self._turn:
            res = self.fused.best_path(use_final_probs=final)
        return _words(res, self.words)


def fused_session_factory(am, graph, opts, feat_opts, words, device="cuda",
                          **fused_kw):
    """-> a zero-argument factory of `FusedDecodeSession`s, each over its
    own `CsrBeamDecoder(graph, opts, device)` and `FusedOnlineDecoder(am,
    ..., feat_opts, **fused_kw)`: a decoder swaps its options during a
    lattice decode and writes its `last_*` counters, and a fused decoder
    holds its stream's state, so connections served at once share only
    the AM and the graph. On a CUDA device the gather kernel is built
    here, before the server takes its first connection.

    The sessions take turns on one lock: a chunk's host loop is Python
    that enqueues a few hundred small device ops, and connection threads
    that interleave those op by op (each op gives the GIL up and takes it
    back) ran six 6 s streams 6x slower than one after the other on an
    NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 32). Turns keep
    each chunk's ops together; the sockets' reads and writes still
    overlap."""
    from kaldi_tpu_torch import cuda_build
    from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.online.fused import FusedOnlineDecoder

    dev = resolve_device(device)
    if dev.type == "cuda":
        cuda_build.build(["table_gather"])

    turn = threading.Lock()

    def session():
        with turn:
            dec = CsrBeamDecoder(graph, opts, device=dev)
            fused = FusedOnlineDecoder(am, dec, feat_opts, **fused_kw)
        return FusedDecodeSession(fused, words, turn)

    return session


class AudioServer:
    def __init__(self, host: str, port: int, session_factory,
                 chunk_bytes: int = 8192):
        self.addr = (host, port)
        self.session_factory = session_factory
        self.chunk_bytes = chunk_bytes
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sess = outer.session_factory()
                last = ""
                while True:
                    data = self.request.recv(outer.chunk_bytes)
                    if not data:
                        break
                    sess.accept_pcm(data)
                    hyp = sess.hypothesis()
                    if hyp != last:
                        self.request.sendall(
                            f"PARTIAL {hyp}\n".encode())
                        last = hyp
                sess.finish()
                self.request.sendall(
                    f"FINAL {sess.hypothesis(final=True)}\n".encode())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(self.addr, Handler)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def serve(self, num_connections: int):
        """Handle exactly num_connections connections, then close —
        the scripted-use loop (the reference servers run forever)."""
        for _ in range(max(num_connections, 1)):
            self._server.handle_request()
        self._server.server_close()

    def serve_in_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


def stream_wave(host: str, port: int, wave: np.ndarray,
                chunk_samples: int = 4000,
                timings: dict | None = None) -> list[str]:
    """Test/demo client: stream float wave as PCM16, return server lines.
    With `timings`, records `time.perf_counter()` at the first send
    ("start"), after the write side is shut ("shut_wr") and when the FINAL
    line has arrived ("final")."""
    pcm = np.clip(wave, -32768, 32767).astype("<i2").tobytes()

    def clock(key):
        if timings is not None:
            timings[key] = time.perf_counter()

    with socket.create_connection((host, port)) as s:
        clock("start")
        for lo in range(0, len(pcm), chunk_samples * 2):
            s.sendall(pcm[lo: lo + chunk_samples * 2])
        s.shutdown(socket.SHUT_WR)
        clock("shut_wr")
        buf = b""
        while True:
            data = s.recv(4096)
            if not data:
                break
            buf += data
            if b"FINAL " in buf and buf.endswith(b"\n"):
                clock("final")
    return [ln for ln in buf.decode().splitlines() if ln]
