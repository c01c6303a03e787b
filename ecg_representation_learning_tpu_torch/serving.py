"""Minimal batch-inference HTTP server, the port of the JAX package's serving.py.

The model stays resident on the GPU inside a ``train.Trainer``; requests are
plain JSON over stdlib ``http.server``.  Concurrency model:
``ThreadingHTTPServer`` accepts in parallel; concurrent requests are
COALESCED into one device dispatch by a :class:`MicroBatcher` (continuous
batching): while one dispatch is on the device, arrivals queue up and the
next dispatch takes them all in a single (sum-N, C, L) call.  Device cost is
flat in the coalesced size up to ``eval_batch_size`` because ``predict``
pads partial batches to that fixed shape -- so K concurrent batch-1 clients
cost ~1/K of the serialized path.  An optional ``max_wait_ms`` adds a
collection deadline for bursty low-concurrency traffic; the default 0 relies
purely on natural accumulation and adds zero latency to a lone request.

API:
  GET  /health   -> {"status": "ok", "model": ..., "num_class": ...}
  POST /predict  {"signals": [[[...],...12 leads...]], "top_k": 5}
                 -> {"probs": [[...num_class...]],
                     "top": [[{"code", "description", "prob"}, ...]]}

Wire format: raw 250 Hz signals, shape (N, C, L) with C = the model's lead
count; normalization/padding happen on the device (Trainer.predict).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from .registry import PTBXL_CODE2DESCRIPTION, PTBXL_ID2CODE


class _Pending:
    """One caller's slice of a coalesced dispatch."""
    __slots__ = ('signals', 'agg', 'event', 'probs', 'error')

    def __init__(self, signals: np.ndarray, agg: str):
        self.signals = signals
        self.agg = agg
        self.event = threading.Event()
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Cross-request coalescing for single-device inference.

    Caller threads :meth:`submit` their (N, C, L) signals and block; a single
    dispatcher thread drains the pending list, concatenates requests that
    share a batching key ``(L, agg)`` (mixed lengths cannot share one device
    call) into ONE dispatch of ``runner(signals, agg)``, then splits the
    result rows back per caller.  Because dispatches are serialized in the
    dispatcher thread, arrivals during an in-flight dispatch accumulate and
    ride the next one -- continuous batching with no added latency for a
    lone request.  ``max_wait_ms > 0`` additionally holds the FIRST request
    of a batch up to that deadline to let stragglers join (burst smoothing).

    Error semantics: a runner exception fans out to every caller in the
    coalesced batch (they shared the device call); validation stays in the
    caller thread, before submit.
    """

    def __init__(self, runner, max_batch: int = 1024,
                 max_wait_ms: float = 0.0):
        self._runner = runner
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._cv = threading.Condition()
        self._pending: List[_Pending] = []
        self._closed = False
        self.dispatches = 0          # observability: device calls made
        self.requests = 0            # ... vs requests served
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='microbatcher')
        self._thread.start()

    def submit(self, signals: np.ndarray, agg: str) -> np.ndarray:
        p = _Pending(signals, agg)
        with self._cv:
            if self._closed:
                raise RuntimeError('MicroBatcher is closed')
            self._pending.append(p)
            self._cv.notify()
        # re-wait while the dispatcher is alive (a device dispatch may take
        # arbitrarily long, e.g. the first call's kernel build); if the dispatcher thread
        # died without setting our event, surface that instead of hanging the
        # caller forever
        while not p.event.wait(timeout=1.0):
            if not self._thread.is_alive():
                raise RuntimeError('MicroBatcher dispatcher thread is dead; '
                                   'request cannot complete')
        if p.error is not None:
            raise p.error
        return p.probs

    def close(self, join_timeout: float = 5.0) -> bool:
        """Stop the dispatcher.  Returns True if it exited within
        ``join_timeout`` seconds; False means a dispatch was still in flight
        and the daemon thread is leaked (logged, so tests/benchmarks can
        detect a wedged dispatcher instead of a silent leak)."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            import logging
            logging.getLogger('ecg_torch.serving').warning(
                'MicroBatcher.close: dispatcher still running after '
                '%.1fs (in-flight device dispatch?); daemon thread leaked',
                join_timeout)
            return False
        return True

    # ------------------------------------------------------------ dispatcher
    def _take_matching(self, key, n: int, batch: List[_Pending]) -> int:
        """Pull every pending request with this key (FIFO) into ``batch``
        until max_batch; returns the new sample count.  Caller holds _cv."""
        i = 0
        while i < len(self._pending) and n < self.max_batch:
            p = self._pending[i]
            if ((p.signals.shape[-1], p.agg) == key
                    and n + p.signals.shape[0] <= self.max_batch):
                batch.append(self._pending.pop(i))
                n += p.signals.shape[0]
            else:
                i += 1
        return n

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                first = self._pending.pop(0)
                batch = [first]
                key = (first.signals.shape[-1], first.agg)
                n = self._take_matching(key, first.signals.shape[0], batch)
            if self.max_wait > 0:
                deadline = time.monotonic() + self.max_wait
                while n < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    with self._cv:
                        before = n
                        n = self._take_matching(key, n, batch)
                        if n >= self.max_batch:
                            break
                        if n == before:
                            self._cv.wait(timeout=left)
            # the WHOLE per-batch body -- assembly (np.concatenate can raise
            # MemoryError), device call, result split -- fans faults out to
            # the callers, and the events are set in a finally: no exception
            # path may leave a caller blocked or kill the dispatcher loop
            try:
                sigs = (np.concatenate([p.signals for p in batch], axis=0)
                        if len(batch) > 1 else first.signals)
                probs = self._runner(sigs, key[1])
                off = 0
                for p in batch:
                    m = p.signals.shape[0]
                    p.probs = probs[off:off + m]
                    off += m
            except BaseException as e:  # noqa: BLE001 -- fan the fault out
                for p in batch:
                    p.error = e
            finally:
                self.dispatches += 1
                self.requests += len(batch)
                for p in batch:
                    p.event.set()


class InferenceService:
    """Request handling as a pure(ish) object, independent of HTTP -- the
    unit under test.  Wraps a ``train.Trainer`` with loaded params."""

    def __init__(self, trainer, default_top_k: int = 5,
                 max_batch: int = 1024, max_wait_ms: float = 0.0):
        self.trainer = trainer
        self.default_top_k = default_top_k
        self.max_batch = max_batch
        # predict_long routes internally: direct lossless predict() for
        # L < max_signal_length, sliding windows + per-class aggregation
        # for long records (e.g. a full INCART strip).  The batcher owns
        # device serialization (single dispatcher thread), so no lock.
        self.batcher = MicroBatcher(
            lambda sigs, agg: trainer.predict_long(sigs, agg=agg),
            max_batch=max_batch, max_wait_ms=max_wait_ms)

    def close(self) -> None:
        self.batcher.close()

    def health(self) -> Dict[str, Any]:
        cfg = self.trainer.model_cfg
        return {'status': 'ok', 'model': self.trainer.name,
                'num_class': cfg.num_class, 'num_channels': cfg.num_channels,
                'max_signal_length': cfg.max_signal_length,
                'requests': self.batcher.requests,
                'dispatches': self.batcher.dispatches}

    def warmup(self) -> None:
        """Run one request before the first client (builds the kernels)."""
        cfg = self.trainer.model_cfg
        dummy = np.zeros((1, cfg.num_channels, cfg.max_signal_length
                          - cfg.patch_size), np.float32)
        self.predict({'signals': dummy.tolist(), 'top_k': 1})

    def predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(payload, dict):
            raise ValueError(f'request body must be a JSON object, '
                             f'got {type(payload).__name__}')
        signals = np.asarray(payload.get('signals'), np.float32)
        if signals.ndim == 2:      # single record (C, L)
            signals = signals[None]
        if signals.ndim != 3:
            raise ValueError(f'signals must be (N, C, L) or (C, L); '
                             f'got shape {signals.shape}')
        cfg = self.trainer.model_cfg
        if signals.shape[1] != cfg.num_channels:
            raise ValueError(f'expected {cfg.num_channels} leads, '
                             f'got {signals.shape[1]}')
        if signals.shape[0] > self.max_batch:
            raise ValueError(f'batch too large: {signals.shape[0]} > '
                             f'{self.max_batch}')
        k = int(payload.get('top_k', self.default_top_k))
        agg = str(payload.get('agg', 'max'))
        if agg not in ('max', 'mean'):
            raise ValueError(f"agg must be 'max' or 'mean', got {agg!r}")
        # coalesced with concurrent requests of the same (L, agg) into one
        # device dispatch; rows come back in this request's order
        probs = self.batcher.submit(signals, agg)
        order = np.argsort(-probs, axis=1)[:, :k]
        n_code = len(PTBXL_ID2CODE)
        top = [[{'code': PTBXL_ID2CODE[int(c)] if c < n_code else str(int(c)),
                 'description': PTBXL_CODE2DESCRIPTION.get(
                     PTBXL_ID2CODE[int(c)], '') if c < n_code else '',
                 'prob': round(float(probs[i, c]), 6)}
                for c in order[i]] for i in range(probs.shape[0])]
        return {'probs': np.round(probs, 6).tolist(), 'top': top}


def _make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._send(200, service.health())
            else:
                self._send(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            if self.path != '/predict':
                self._send(404, {'error': f'unknown path {self.path}'})
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(n) or b'{}')
                self._send(200, service.predict(payload))
            except (ValueError, TypeError, KeyError,
                    json.JSONDecodeError) as e:
                # malformed payload -> 400 (non-retryable client error)
                self._send(400, {'error': f'{type(e).__name__}: {e}'})
            except Exception as e:  # server-side fault (device OOM, CUDA
                # runtime error, ...) -> 500 so clients/load-balancers may
                # retry; never a dropped connection either way
                self._send(500, {'error': f'{type(e).__name__}: {e}'})

        def log_message(self, fmt, *args):  # route through our logger
            pass

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 resets the connections of a
    # burst of concurrent clients before a handler thread accepts them
    request_queue_size = 128


def serve(trainer, host: str = '127.0.0.1', port: int = 8000,
          warmup: bool = True, max_wait_ms: float = 0.0
          ) -> ThreadingHTTPServer:
    """Start the inference server (returns the server; call
    ``serve_forever()`` to block, or use the returned handle in tests).

    ``max_wait_ms``: optional micro-batching collection deadline -- 0 (the
    default) coalesces only requests that arrive while a dispatch is in
    flight (no added latency); >0 additionally holds the first request of a
    batch that long to let stragglers join."""
    service = InferenceService(trainer, max_wait_ms=max_wait_ms)
    if warmup:
        service.warmup()
    httpd = _Server((host, port), _make_handler(service))
    httpd.service = service
    return httpd
