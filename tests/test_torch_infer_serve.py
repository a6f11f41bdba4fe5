"""The port's serving surface against the JAX package's, on the CPU.

One small checkpoint (inceptionv4, 2 stages, 64 px) is exported from a JAX
MargiPose to the reference ``.pth`` format, which both packages load.
``infer_image`` and the HTTP server of each package then see the same image;
their coordinates must agree to atol 1e-4 in float32 (float32 sums in
another order, through a 64 px model). Both servers letterbox with their
native host sampler, the same library, so both see the same pixels.
"""

import concurrent.futures
import http.client
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import margipose_tpu.bin.infer_single as jax_infer
import margipose_tpu.bin.serve as jax_serve
from margipose_tpu.ops.image import affine_warp as jax_affine_warp
from margipose_tpu.train.torch_import import export_state_dict
from margipose_tpu_torch.bin import infer_single, serve
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.ops.dsnt import dsnt, flat_softmax
from margipose_tpu_torch.ops.image import affine_warp
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(ROOT, 'resources', 'man_running.jpg')
ATOL = 1e-4


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=4)
    path = str(tmp_path_factory.mktemp('ckpt') / 'small.pth')
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in export_state_dict(variables).items()}
    torch.save({'state_dict': state, 'model_desc': desc}, path)
    return path, desc, jax_model, variables


def _png(seed, size=(96, 80)):
    arr = np.random.RandomState(seed).randint(0, 256, size[::-1] + (3,), dtype=np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(arr, 'RGB').save(buf, format='PNG')
    return buf.getvalue()


@pytest.mark.parametrize('multicrop', [False, True], ids=['single', 'multicrop'])
def test_infer_image_matches_jax(exported, multicrop):
    path, desc, jax_model, variables = exported
    image = PIL.Image.open(IMAGE)
    jax_inp, jax_coords = jax_infer.infer_image(jax_model, variables, image, desc,
                                                multicrop=multicrop)
    model, model_desc = load_model(path)
    inp, coords = infer_single.infer_image(model, image, model_desc, multicrop=multicrop,
                                           device='cpu')
    assert inp.shape == (64, 64, 3) and coords.shape == (17, 3)
    # the input is normalised: pixel rounding divided by std (about 0.225)
    np.testing.assert_allclose(inp, np.asarray(jax_inp), rtol=0, atol=5e-5)
    np.testing.assert_allclose(coords, jax_coords, rtol=0, atol=ATOL)


class _BlobModel(torch.nn.Module):
    """Soft-argmax of the input's brightness: every joint at the blob."""

    def forward(self, x):
        xy = dsnt(flat_softmax(x.mean(1, keepdim=True) * 20.0))[:, 0]
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], 0.3)], -1)
        return xyz[:, None].expand(-1, 17, -1), None


def test_multicrop_backmap_geometry():
    """As tests/test_cli.py holds the JAX infer: each crop sees the blob
    somewhere else, but the merged prediction must land on the base-frame
    blob, where the single crop sees it."""
    img = np.zeros((256, 256, 3), np.uint8)
    by, bx = 108, 158  # off-centre in both axes
    img[by - 5:by + 6, bx - 5:bx + 6] = 255
    pil = PIL.Image.fromarray(img)
    _, single = infer_single.infer_image(_BlobModel(), pil, multicrop=False, device='cpu')
    _, merged = infer_single.infer_image(_BlobModel(), pil, multicrop=True, device='cpu')
    expect = [(bx + 0.5) * 2 / 256 - 1, (by + 0.5) * 2 / 256 - 1]
    np.testing.assert_allclose(single[0, :2], expect, atol=0.02)
    np.testing.assert_allclose(merged[:, :2], single[:, :2], atol=0.02)
    np.testing.assert_allclose(merged[:, 2], 0.3, atol=1e-5)
    affines = infer_single._multicrop_affines(np.eye(3, dtype=np.float32), 256)
    np.testing.assert_array_equal(affines, jax_infer._multicrop_affines(np.eye(3, dtype=np.float32),
                                                                        256))


def test_infer_cli_writes_a_png(exported, tmp_path, capsys):
    path = exported[0]
    out_file = str(tmp_path / 'result.png')
    infer_single.main(['--model', path, '--image', IMAGE, '--out-file', out_file,
                       '--device', 'cpu'])
    assert os.path.getsize(out_file) > 0
    assert 'Normalized skeleton coordinates' in capsys.readouterr().out
    assert infer_single.parse_args(['--model', 'm', '--image', 'i']).device == 'cuda'


def test_letterbox_matches_jax_and_affine_warp():
    """The server's host letterbox is the JAX server's: the native host
    sampler after the same prefilter, bit for bit. Against infer's pixels
    (the prefilter and the device warp, both packages') it agrees to uint8
    rounding on every pixel, the content's far edge included: the native
    sampler, like the device warp, blends with zero where a pixel's bilinear
    footprint reaches past the last source row or column."""
    rng = np.random.RandomState(0)
    w = h = 64
    for iw, ih in ((160, 96), (48, 40), (70, 150)):
        image = PIL.Image.fromarray(rng.randint(0, 256, (ih, iw, 3), dtype=np.uint8), 'RGB')
        got = serve.letterbox_uint8(image, w, h)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_serve.letterbox_uint8(image, w, h))

        src, affine = infer_single.prefilter(image, w, h)
        src = src.astype(np.float32)[None] / 255.0
        warped = affine_warp(torch.from_numpy(src), torch.from_numpy(affine[None]), h, w)[0]
        jax_warped = np.asarray(jax_affine_warp(jnp.asarray(src), jnp.asarray(affine[None]),
                                                h, w))[0]
        for ref_pixels in (warped.numpy(), jax_warped):
            np.testing.assert_allclose(got / np.float32(255.0), ref_pixels, rtol=0,
                                       atol=2.0 / 255.0)
        assert (got[-1] == 0).all() or (got[:, -1] == 0).all()  # the black canvas


def test_microbatcher_failure_paths():
    """As tests/test_cli.py holds the JAX one: a runner's Exception fails its
    batch and the batcher lives on; a BaseException kills it, fails queued
    waiters, flips alive() (the /healthz 503) and makes submit fail fast;
    waits are bounded; an item put after the batcher died is failed by its
    submitter."""
    calls = []

    def flaky(batch):
        calls.append(len(batch))
        if len(calls) == 1:
            raise ValueError('transient device error')
        return np.zeros((batch.shape[0], 17, 3))

    img = np.zeros((4, 4, 3), np.uint8)
    b = serve.Microbatcher(flaky, batch_size=2, max_wait_s=0.01)
    it = b.submit(img)
    assert it.event.wait(timeout=10) and isinstance(it.error, ValueError) and b.alive()
    it2 = b.submit(img)
    assert it2.event.wait(timeout=10)
    assert it2.error is None and it2.result.shape == (17, 3)
    assert calls == [2, 2]  # padded to the one batch shape

    gate = threading.Event()

    def fatal(batch):
        gate.wait(5)
        raise SystemExit('worker killed')

    b2 = serve.Microbatcher(fatal, batch_size=2, max_wait_s=0.01)
    first = b2.submit(img)
    time.sleep(0.1)  # let the batch window close so 'queued' lands after it
    queued = b2.submit(img)
    gate.set()
    assert first.event.wait(timeout=10) and queued.event.wait(timeout=10)
    assert 'died' in str(first.error) and 'died' in str(queued.error)
    for _ in range(100):  # thread teardown races the flag by a hair
        if not b2.alive():
            break
        time.sleep(0.05)
    assert not b2.alive()
    with pytest.raises(RuntimeError, match='dead'):
        b2.submit(img)

    b3 = serve.Microbatcher(lambda batch: time.sleep(30), batch_size=1, max_wait_s=0.01)
    it3 = b3.submit(img)
    t0 = time.monotonic()
    assert not it3.event.wait(timeout=0.2)  # the /predict handler's bounded wait
    assert time.monotonic() - t0 < 5

    b4 = serve.Microbatcher(lambda batch: np.zeros((batch.shape[0], 17, 3)), batch_size=2,
                            max_wait_s=0.01)
    orig_put = b4.queue.put

    def racing_put(item):
        b4.fatal = SystemExit('simulated death')  # dies between the check and the put
        orig_put(item)

    b4.queue.put = racing_put
    late = b4.submit(img)
    assert late.event.is_set() and 'died' in str(late.error)
    b4.queue.put = orig_put
    with pytest.raises(RuntimeError, match='dead'):
        b4.submit(img)


class _Running:
    """A server from ``create_server`` answering on a thread."""

    def __init__(self, server):
        self.server = server
        self.host, self.port = server.server_address[:2]
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def url(self, path):
        return f'http://{self.host}:{self.port}{path}'

    def get(self, path):
        with urllib.request.urlopen(self.url(path), timeout=30) as resp:
            return json.loads(resp.read())

    def post(self, body):
        req = urllib.request.Request(self.url('/predict'), data=body, method='POST')
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _coords(reply):
    assert reply['skeleton'] == 'canonical-17' and len(reply['joints']) == 17
    return np.array(list(reply['joints'].values()))


def test_serve_http(exported):
    """/healthz, /info, two concurrent /predict requests through the
    microbatcher (equal to the runner's own output on their letterboxed
    pixels), bad bodies answered 4xx with the server alive, /metrics."""
    path = exported[0]
    running = _Running(serve.create_server(path, port=0, batch_size=2, max_wait_ms=300.0,
                                           precision='float32', device='cpu'))
    try:
        assert running.get('/healthz') == {'status': 'ok'}
        info = running.get('/info')
        assert info['batch_size'] == 2 and info['precision'] == 'float32'
        assert info['input'] == {'width': 64, 'height': 64} and len(info['joints']) == 17
        assert info['model'] == {'type': 'margipose', 'version': '6.0.1'}

        bodies = [_png(1), _png(2, size=(50, 120))]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            replies = list(pool.map(running.post, bodies))
        runner, _, _ = serve.make_runner(path, 'float32', 'cpu')
        pixels = [serve.letterbox_uint8(PIL.Image.open(io.BytesIO(b)), 64, 64) for b in bodies]
        for reply, px in zip(replies, pixels):
            assert 1 <= reply['batched_with'] <= 2
            direct = runner(np.stack([px, px]))[0]
            np.testing.assert_allclose(_coords(reply), direct, rtol=0, atol=1e-6)
        assert not np.allclose(_coords(replies[0]), _coords(replies[1]))

        for bad in (b'not an image', bodies[0][:len(bodies[0]) // 2]):
            with pytest.raises(urllib.error.HTTPError) as err:
                running.post(bad)
            assert err.value.code == 400
            assert running.get('/healthz') == {'status': 'ok'}
        for length, status in ((str(1 << 30), 413), ('-1', 400)):
            conn = http.client.HTTPConnection(running.host, running.port, timeout=30)
            try:
                conn.putrequest('POST', '/predict')
                conn.putheader('Content-Length', length)
                conn.endheaders()
                assert conn.getresponse().status == status
            finally:
                conn.close()
        with pytest.raises(urllib.error.HTTPError) as err:
            running.get('/nowhere')
        assert err.value.code == 404

        metrics = running.get('/metrics')
        assert metrics['requests_total'] == 6 and metrics['ok_total'] == 2
        assert metrics['rejected_total'] == 4 and metrics['errors_total'] == 0
        assert 1 <= metrics['batches_total'] <= 2 and metrics['batched_images_total'] == 2
        lat = metrics['latency_ms']
        assert 0 < lat['p50'] <= lat['p95'] <= lat['max']
        assert metrics['batch_occupancy_mean'] >= 1
    finally:
        running.close()


def test_served_coords_match_jax_server(exported):
    path = exported[0]
    body = _png(3, size=(120, 90))
    replies = []
    for make in (jax_serve.create_server,
                 lambda *a, **k: serve.create_server(*a, device='cpu', **k)):
        running = _Running(make(path, port=0, batch_size=2, max_wait_ms=5.0,
                                precision='float32'))
        try:
            replies.append(_coords(running.post(body)))
        finally:
            running.close()
    np.testing.assert_allclose(replies[1], replies[0], rtol=0, atol=ATOL)


def test_bf16_serve_request_is_finite(exported):
    running = _Running(serve.create_server(exported[0], port=0, batch_size=2,
                                           device='cpu'))
    try:
        assert running.get('/info')['precision'] == 'bfloat16'
        coords = _coords(running.post(_png(4)))
        assert np.isfinite(coords).all() and np.abs(coords).max() <= 1.5
    finally:
        running.close()
    args = serve.parse_args(['--model', 'm'])
    assert (args.device, args.batch_size, args.max_wait_ms, args.precision,
            args.predict_timeout_s) == ('cuda', 8, 5.0, 'bfloat16', 60.0)
