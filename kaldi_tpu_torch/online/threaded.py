"""Threaded single-stream online decoding: audio acceptance never blocks
on acoustic scoring or search.

(ref: online2/online-nnet2-decoding-threaded.h:64
 SingleUtteranceNnet2DecoderThreaded — the reference runs feature
 extraction + nnet evaluation + decoding in background threads so the
 caller's AcceptWaveform returns immediately. Here the same contract:
 a producer/consumer split where the caller thread only appends audio to
 a queue, and one worker thread drives features -> TDNN scoring (torch
 releases the GIL during device work) -> chunked beam search. The
 reference needs three threads and a hand-built ThreadSynchronizer; the
 batched decoder collapses nnet+search into one consumer.)

Counterpart of kaldi_tpu/online/threaded.py, over the port's
`SingleUtteranceNnet2Decoder`, which runs on its decoder's device. An
error in the worker thread is raised on `wait()`.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class ThreadedSingleUtteranceDecoder:
    """Wraps SingleUtteranceNnet2Decoder with a decode worker thread.

    accept_waveform() is non-blocking (bounded queue, large); the worker
    consumes audio chunks, advances the feature pipeline and decoder, and
    exposes best_path()/endpoint_detected() snapshots.
    """

    def __init__(self, inner, max_queue_chunks: int = 1024):
        self.inner = inner            # SingleUtteranceNnet2Decoder
        self._q: queue.Queue = queue.Queue(maxsize=max_queue_chunks)
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- caller (producer) side: never blocks on decoding ----

    def accept_waveform(self, wave: np.ndarray):
        self._q.put(np.asarray(wave))

    def input_finished(self):
        self._q.put(None)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the worker has consumed everything after
        input_finished(); -> False on timeout."""
        ok = self._done.wait(timeout)
        if self._error is not None:
            raise self._error
        return ok

    # ---- snapshots (safe to call from the producer thread) ----

    def best_path(self):
        with self._lock:
            return self.inner.best_path()

    def endpoint_detected(self) -> bool:
        with self._lock:
            return self.inner.endpoint_detected()

    def num_frames_decoded(self) -> int:
        with self._lock:
            return self.inner.decoder.num_frames_decoded

    # ---- worker (consumer) side ----

    def _run(self):
        try:
            while True:
                chunk = self._q.get()
                if chunk is None:
                    with self._lock:
                        self.inner.finalize_decoding()
                    break
                # drain any backlog so scoring batches up when the
                # producer runs ahead (the reference's nnet thread also
                # evaluates all available frames at once)
                chunks = [chunk]
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._q.put(None)   # re-queue the terminator
                        break
                    chunks.append(nxt)
                audio = np.concatenate(chunks)
                with self._lock:
                    self.inner.pipeline.accept_waveform(audio)
                    self.inner.advance_decoding()
        except BaseException as e:           # surfaced on wait()
            self._error = e
        finally:
            self._done.set()
