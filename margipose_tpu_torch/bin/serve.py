#!/usr/bin/env python3
"""Batched HTTP inference server on the card.

Counterpart of ``margipose_tpu/bin/serve.py``, with the same endpoints,
status codes, limits and defaults::

    python -m margipose_tpu_torch.bin.serve --model FILE.pth --port 8800 [--device cpu]
    curl -X POST --data-binary @person.jpg localhost:8800/predict

Endpoints:
    POST /predict   image bytes (JPEG/PNG/...) -> JSON normalized skeleton
    GET  /healthz   liveness probe -> {"status": "ok"}; 503 once the
                    microbatcher thread has died
    GET  /info      model/server configuration (type, version, input size,
                    skeleton joints, batch size, precision)
    GET  /metrics   serving counters + latency quantiles over a sliding
                    window. Counters cover POST /predict traffic only:
                    requests_total counts every received request,
                    ok/rejected/errors split it by outcome (2xx/4xx/5xx).
                    ok_total counts COMPUTED responses; a client that
                    disconnects before the response body lands is
                    additionally tallied in write_failures_total.

Handler threads decode and letterbox an image on the host (content at the
top-left, as ``infer`` places it) into uint8 pixels. One dispatcher thread
collects up to ``--batch-size`` requests (waiting at most ``--max-wait-ms``
after the first), pads the batch to its one shape by repeating the last
image, uploads it as uint8, renormalises it on the device and runs the
forward under ``torch.inference_mode()``, in bf16 autocast by default. One
batch shape means cuDNN builds its plans once, at warmup, which runs on the
dispatcher's thread (PyTorch caches cuDNN's plans per thread). The
algorithms are cuDNN's heuristic choice, the same on every thread. The result
comes back through ``.cpu()``, which waits for the card, so a failing launch
answers 500, not a wrong skeleton. Waits are bounded by
``--predict-timeout-s`` (504 on expiry).
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import queue
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import monotonic, perf_counter

import numpy as np
import PIL.Image
import torch

from margipose_tpu_torch import native, resolve_device
from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
from margipose_tpu_torch.bin.infer_single import prefilter
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.cli import bin_subcommand
from margipose_tpu_torch.data.specs import device_input
from margipose_tpu_torch.geometry.transforms import warp_image_pil
from margipose_tpu_torch.models import data_specs_for_desc
from margipose_tpu_torch.parallel.precision import compute_dtype_scope, resolve_dtype


class ServingStats:
    """Thread-safe serving counters + bounded reservoirs for quantiles.

    The reservoirs keep the most recent ``window`` observations so /metrics
    reflects current behaviour (a deploy's cold-start spike ages out) and
    memory stays O(window) regardless of uptime.
    """

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.window = window
        self.requests_total = 0
        self.ok_total = 0
        self.rejected_total = 0
        self.errors_total = 0
        self.write_failures_total = 0
        self.batches_total = 0
        self.batched_images_total = 0
        self._latencies_ms = collections.deque(maxlen=window)
        self._occupancies = collections.deque(maxlen=window)

    def record_received(self):
        with self._lock:
            self.requests_total += 1

    def record_ok(self, latency_ms: float):
        with self._lock:
            self.ok_total += 1
            self._latencies_ms.append(latency_ms)

    def record_rejected(self):
        with self._lock:
            self.rejected_total += 1

    def record_error(self):
        with self._lock:
            self.errors_total += 1

    def record_write_failure(self):
        with self._lock:
            self.write_failures_total += 1

    def record_batch(self, n_items: int):
        with self._lock:
            self.batches_total += 1
            self.batched_images_total += n_items
            self._occupancies.append(n_items)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies_ms)
            occ = list(self._occupancies)
            out = {
                'requests_total': self.requests_total,
                'ok_total': self.ok_total,
                'rejected_total': self.rejected_total,
                'errors_total': self.errors_total,
                'write_failures_total': self.write_failures_total,
                'batches_total': self.batches_total,
                'batched_images_total': self.batched_images_total,
                'window': self.window,
            }
        if lat:
            out['latency_ms'] = {
                'p50': round(lat[len(lat) // 2], 3),
                'p95': round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 3),
                'max': round(lat[-1], 3),
            }
        if occ:
            out['batch_occupancy_mean'] = round(sum(occ) / len(occ), 3)
        return out


class _Pending:
    __slots__ = ('image', 'event', 'result', 'error', 'batched_with')

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batched_with = 0


class Microbatcher:
    """Collects requests into fixed-size batches for one forward.
    ``runner`` maps a uint8 [B,H,W,3] array to [B,J,3] coords."""

    def __init__(self, runner, batch_size: int, max_wait_s: float,
                 on_batch=None):
        self.runner = runner
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.on_batch = on_batch
        self.queue: queue.Queue[_Pending] = queue.Queue()
        self.fatal: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def alive(self) -> bool:
        return self.fatal is None and self._thread.is_alive()

    def submit(self, image: np.ndarray) -> _Pending:
        if not self.alive():
            raise RuntimeError(
                f'microbatcher thread is dead: {self.fatal!r}')
        item = _Pending(image)
        self.queue.put(item)
        # Close the alive()-check -> put race: if the batcher died in
        # between, its fatal-path queue drain may have run before this put
        # landed, stranding the item until the 504 timeout. fatal is set
        # BEFORE the drain, so observing it here means the drain might have
        # missed us: fail the item directly (idempotent if the drain also
        # got it: both write error and set the event).
        if self.fatal is not None and not item.event.is_set():
            item.error = RuntimeError(
                f'microbatcher thread died: {self.fatal!r}')
            item.event.set()
        return item

    def _loop(self):
        while True:
            items = [self.queue.get()]
            deadline = monotonic() + self.max_wait_s
            while len(items) < self.batch_size:
                remaining = deadline - monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                batch = np.stack(
                    [it.image for it in items]
                    + [items[-1].image] * (self.batch_size - len(items)))
                coords = np.asarray(self.runner(batch), np.float64)
                for i, it in enumerate(items):
                    it.result = coords[i]
                    it.batched_with = len(items)
                if self.on_batch is not None:
                    self.on_batch(len(items))
            except Exception as exc:  # surface to every waiting request
                for it in items:
                    it.error = exc
            except BaseException as exc:
                # fatal (SystemExit etc.): record it so alive() flips false
                # (-> /healthz 503, submit fail-fast), fail this batch AND
                # everything already queued, then let the thread die
                self.fatal = exc
                err = RuntimeError(f'microbatcher thread died: {exc!r}')
                while True:
                    for it in items:
                        it.error = err
                        it.event.set()
                    try:
                        items = [self.queue.get_nowait()]
                    except queue.Empty:
                        break
                raise
            for it in items:
                it.event.set()


def letterbox_uint8(image: PIL.Image.Image, width: int, height: int) -> np.ndarray:
    """Aspect-fit the image into (width, height) with content at the
    top-left on a black canvas, returned as uint8 HWC.

    The same pixels ``infer`` sees (``bin/infer_single.infer_image``): the
    same host prefilter (``infer_single.prefilter``), then the same bilinear
    affine resample, here the native host sampler (``native.warp_rgb``, the
    JAX server's), which blends with zero past the content's edge as the
    device warp (``ops/image.affine_warp``) does: the two agree to uint8
    rounding on every pixel. Under ``MARGIPOSE_DISABLE_NATIVE``, PIL's warp,
    as the JAX server's fallback."""
    src, affine = prefilter(image, width, height)
    if native.available():
        return native.warp_rgb(src, affine, (width, height))
    return np.array(warp_image_pil(PIL.Image.fromarray(src, 'RGB'), affine, (width, height)),
                    np.uint8)


def make_runner(ckpt_path: str, precision: str, device='cuda'):
    """Load the checkpoint and build the forward: ``runner(batch_u8 [B,H,W,3])
    -> float32 xyz [B,J,3]`` as numpy. Returns (runner, data_specs,
    model_desc)."""
    device = resolve_device(device)
    model, model_desc = load_model(ckpt_path, device)
    specs = data_specs_for_desc(model_desc)
    return model_runner(model, specs.input_specs, precision, device), specs, model_desc


def model_runner(model, input_specs, precision: str, device):
    """``make_runner``'s forward of a model already on ``device`` (the
    benchmark's serve cell runs it on a model made from a seed)."""
    compute_dtype = resolve_dtype(precision)
    if compute_dtype in (None, torch.float32):
        set_float32_parity_mode()

    def runner(batch_u8: np.ndarray) -> np.ndarray:
        # inference_mode and autocast are thread-local: entered here, in the
        # microbatcher's thread
        with torch.inference_mode():
            images = device_input(batch_u8, device, input_specs)
            with compute_dtype_scope(compute_dtype, device):
                xyz, _ = model(images)
            return xyz.float().cpu().numpy()  # waits for the card

    return runner


def create_server(ckpt_path: str, host: str = '127.0.0.1', port: int = 0,
                  batch_size: int = 8, max_wait_ms: float = 5.0,
                  precision: str = 'bfloat16', warmup: bool = True,
                  predict_timeout_s: float = 60.0, device='cuda'):
    """Build (but do not start) the HTTP server; ``port=0`` picks a free
    port (see ``server.server_address``). Separated from ``main`` so tests
    drive the real serving stack in-process.

    Turns off cuDNN's timed algorithm search for the process: a search
    picks by timing, per thread, so two threads could pick algorithms that
    round apart; the heuristics pick the same ones on every thread."""
    torch.backends.cudnn.benchmark = False
    runner, specs, model_desc = make_runner(ckpt_path, precision, device)
    input_specs = specs.input_specs
    skeleton_desc = specs.output_specs.skeleton_desc
    joint_names = skeleton_desc.joint_names
    skeleton_label = ('canonical-%d' if skeleton_desc.canonical
                      else 'custom-%d') % skeleton_desc.n_joints
    w, h = input_specs.width, input_specs.height

    stats = ServingStats()
    batcher = Microbatcher(runner, batch_size, max_wait_ms / 1000.0)
    if warmup:
        # through the batcher, on its thread: cuDNN's chosen algorithms are
        # cached per thread, so a warmup on this one would leave the first
        # served batch to search them again
        t0 = perf_counter()
        item = batcher.submit(np.zeros((h, w, 3), np.uint8))
        item.event.wait()
        if item.error is not None:
            raise RuntimeError('serve: the warmup forward failed') from item.error
        print(f'serve: warmup forward in {perf_counter() - t0:.1f}s', file=sys.stderr)
    batcher.on_batch = stats.record_batch  # the warmup batch is not traffic
    info = {
        'model': {'type': model_desc.get('type'),
                  'version': model_desc.get('version')},
        'input': {'width': w, 'height': h},
        'skeleton': skeleton_label,
        'joints': list(joint_names),
        'batch_size': batch_size,
        'max_wait_ms': max_wait_ms,
        'precision': precision,
    }

    class Handler(BaseHTTPRequestHandler):
        # a client that declares a Content-Length and then stalls would
        # otherwise block its handler thread in rfile.read forever
        timeout = 30
        max_body_bytes = 32 << 20

        def log_message(self, fmt, *args):  # quiet per-request stderr spam
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            try:
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                # client went away mid-response; the outcome counters
                # already recorded the computed result
                stats.record_write_failure()
                self.close_connection = True

        def do_GET(self):
            if self.path == '/healthz':
                if batcher.alive():
                    self._json(200, {'status': 'ok'})
                else:
                    self._json(503, {'status': 'unhealthy',
                                     'reason': 'microbatcher thread dead: %r'
                                     % (batcher.fatal,)})
            elif self.path == '/info':
                self._json(200, info)
            elif self.path == '/metrics':
                self._json(200, stats.snapshot())
            else:
                self._json(404, {'error': 'unknown path'})

        def do_POST(self):
            if self.path != '/predict':
                self._json(404, {'error': 'unknown path'})
                return
            stats.record_received()
            try:
                length = int(self.headers.get('Content-Length', 0) or 0)
            except ValueError:
                stats.record_rejected()
                self._json(400, {'error': 'bad Content-Length'})
                return
            if length < 0:
                # rfile.read(-1) would read until EOF/timeout
                stats.record_rejected()
                self._json(400, {'error': 'bad Content-Length'})
                return
            if length > self.max_body_bytes:
                stats.record_rejected()
                self._json(413, {'error': 'body exceeds %d bytes'
                                 % self.max_body_bytes})
                return
            try:
                data = self.rfile.read(length)
                image = PIL.Image.open(io.BytesIO(data))
                # PIL decodes lazily: open() only parses the header, so the
                # full decode (inside letterbox_uint8's convert) runs here,
                # and a truncated body answers 400
                pixels = letterbox_uint8(image, w, h)
            except Exception:
                stats.record_rejected()
                self._json(400, {'error': 'body must be a decodable image'})
                return
            t0 = perf_counter()
            try:
                item = batcher.submit(pixels)
            except RuntimeError as exc:  # batcher dead: fail fast
                stats.record_error()
                self._json(503, {'error': str(exc)})
                return
            if not item.event.wait(timeout=predict_timeout_s):
                stats.record_error()
                self._json(504, {'error': 'inference timed out after %gs'
                                 % predict_timeout_s})
                return
            if item.error is not None or item.result is None:
                stats.record_error()
                self._json(500, {'error': str(item.error or
                                              'no result produced')})
                return
            stats.record_ok((perf_counter() - t0) * 1000.0)
            self._json(200, {
                'skeleton': skeleton_label,
                'joints': {name: [float(v) for v in xyz]
                           for name, xyz in zip(joint_names, item.result)},
                'batched_with': item.batched_with,
                'latency_ms': round((perf_counter() - t0) * 1000.0, 3),
            })

    return ThreadingHTTPServer((host, port), Handler)


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog='margipose-torch-serve', description='batched HTTP inference server',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--model', type=str, metavar='FILE', required=True,
                        help='path to a reference-format .pth model file or a train-state '
                             'directory')
    parser.add_argument('--host', type=str, default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8800)
    parser.add_argument('--batch-size', type=int, default=8,
                        help='microbatch size (the one batch shape)')
    parser.add_argument('--max-wait-ms', type=float, default=5.0,
                        help='max time to hold a request open for batching')
    parser.add_argument('--precision', type=str, default='bfloat16',
                        choices=['float32', 'bfloat16'],
                        help='compute dtype (bfloat16 autocast is the throughput mode)')
    parser.add_argument('--predict-timeout-s', type=float, default=60.0,
                        help='max time a /predict request may wait on the device before '
                             'answering 504')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' runs on the host")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    server = create_server(
        args.model, host=args.host, port=args.port,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        precision=args.precision, predict_timeout_s=args.predict_timeout_s,
        device=args.device)
    host, port = server.server_address[:2]
    print(f'serving on http://{host}:{port} (batch {args.batch_size}, {args.precision}, '
          f'{args.device})', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


Serve_Subcommand = bin_subcommand('serve', main, help='batched HTTP inference server')


if __name__ == '__main__':
    main()
