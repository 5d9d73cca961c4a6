"""Serving in the port (``ihmr_tpu_torch.serve``) against the JAX package's.

The contract of ``tests/test_serve.py``, case for case, carried to the
port's ``MicroBatcher`` and ``InferenceServer`` over real sockets on the
CPU, with the port's predict function (ResNet-18 at 64x64, synthetic MANO):
batching and padding, result routing, error propagation, a bad sample,
saturation and 503, JSON, raw fp32, ``.npy``, a bad length, healthz and
stats, concurrent load, shared batches.

Then the port's ``build_encoder_predict_fn`` against JAX's on the same 5
images and the same weights (random weights and random BatchNorm
statistics, carried across by ``convert.encoder_from_jax``):

  * fp32: the four outputs within the encoder's bound, |port - JAX| <=
    1e-5 + 1e-4 |JAX| (``pipeline.PREDICT_TOL``; measured at most 0.0253
    of the bound, on params);
  * bf16: each output within ``pipeline.BF16_STRICT_BAND`` (0.05) of JAX's:
    max |port bf16 - JAX bf16| at most 0.05x max |JAX bf16 - JAX fp32|,
    JAX's jitted bf16 program compiled with XLA's excess precision off
    (``tests/test_torch_port_bf16.py::STRICT``), so that it rounds where
    flax's casts say. Measured ratios: params 0.00030, joints_3d 0.00043,
    joints_2d 0.00031, hand_type 0, against widths of 2.5e-3, 8.3e-4,
    6.9e-3 and 1.4e-4. The port's fp32 outputs read 1.00 on every output,
    a port whose fc1 adds the bias before rounding 0.37-0.85 (a mutation
    check); every backbone convolution's, BatchNorm's and fc1's input is
    bf16 (``pipeline.backbone_input_dtypes``). Against JAX's program as XLA
    compiles it by default (excess precision: it rounds at fewer places)
    the ratios are 1.01-1.22.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.mano import synthetic_mano_model as jax_synthetic
from ihmr_tpu.models.encoder import InterHandEncoder as FlaxEncoder
from ihmr_tpu.models.encoder import build_mean_params as jax_mean_params
from ihmr_tpu.serve import build_encoder_predict_fn as jax_predict_fn
from ihmr_tpu_torch.convert import encoder_from_jax
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.models import InterHandEncoder, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.pipeline import BF16_STRICT_BAND, PREDICT_TOL, allclose_ratio, backbone_input_dtypes, bf16_band_ratios
from ihmr_tpu_torch.pipeline import max_gaps
from ihmr_tpu_torch.serve import InferenceServer, MicroBatcher, ServerSaturated, build_encoder_predict_fn
from tests.test_torch_port_bf16 import STRICT
from tests.test_torch_port_models import _randomize
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def predict_fn():
    """The port's predict function: seeded ResNet-18 weights, 64x64."""
    encoder = InterHandEncoder(arch="resnet18")
    init_encoder_weights(encoder, torch.Generator().manual_seed(0))
    mean = build_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32), "cpu")
    return build_encoder_predict_fn(encoder, mean, synthetic_mano_model(device="cpu"), 64, "cpu")


def test_microbatcher_batches_and_pads(predict_fn):
    calls = []

    def counting_fn(batch):
        calls.append(batch.shape[0])
        return predict_fn(batch)

    b = MicroBatcher(counting_fn, batch_size=4, max_wait_ms=50)
    try:
        xs = [np.random.RandomState(i).rand(64, 64, 3).astype(np.float32) for i in range(3)]
        outs = b.predict_many(xs)
        assert len(outs) == 3
        for out in outs:
            assert out["params"].shape == (122,)
            assert out["joints_3d"].shape == (42, 3)
            assert np.isfinite(out["joints_3d"]).all()
        assert calls == [4]  # 3 requests in ONE padded call
        s = b.stats()
        assert s["requests"] == 3 and s["batches"] == 1 and s["padded_slots"] == 1
        assert s["batch_efficiency"] == 0.75
    finally:
        b.stop()


def test_microbatcher_result_routing(predict_fn):
    """Each caller gets its own sample's result."""
    b = MicroBatcher(predict_fn, batch_size=4, max_wait_ms=50)
    try:
        xs = [np.full((64, 64, 3), i / 10, np.float32) for i in range(4)]
        outs = b.predict_many(xs)
        for x, out in zip(xs, outs):
            direct = {k: v[0] for k, v in predict_fn(x[None]).items()}
            np.testing.assert_allclose(out["params"], direct["params"], atol=2e-5)
    finally:
        b.stop()


def test_microbatcher_error_propagates():
    def broken(batch):
        raise ValueError("boom")

    b = MicroBatcher(broken, batch_size=2, max_wait_ms=5)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.predict(np.zeros((64, 64, 3), np.float32))
    finally:
        b.stop()


@pytest.fixture()
def server(predict_fn):
    srv = InferenceServer(MicroBatcher(predict_fn, batch_size=4, max_wait_ms=20), (64, 64, 3))
    srv.start(0)
    yield srv
    srv.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, json.loads(r.read())


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post_binary(port, body, ctype, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_healthz_and_stats(server):
    assert _get(server.port, "/healthz") == (200, {"status": "ok"})
    status, stats = _get(server.port, "/stats")
    assert status == 200 and "queue_depth" in stats


def test_http_predict_end_to_end(server):
    imgs = np.random.RandomState(0).rand(2, 64, 64, 3).tolist()
    status, body = _post(server.port, "/predict", {"images": imgs})
    assert status == 200
    results = body["results"]
    assert len(results) == 2
    for r in results:
        assert len(r["params"]) == 122
        assert len(r["joints_3d"]) == 42
        assert len(r["hand_type"]) == 2


def test_http_bad_input_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server.port, "/predict", {"images": [[1, 2, 3]]})
    assert exc.value.code == 400


def test_http_predict_raw_fp32_roundtrip(server):
    """Raw little-endian fp32 in, npz out; the outputs equal the JSON path's
    (same function, same batch composition)."""
    imgs = np.random.RandomState(1).rand(3, 64, 64, 3).astype(np.float32)
    status, ctype, body = _post_binary(server.port, imgs.tobytes(), "application/octet-stream")
    assert status == 200 and ctype == "application/x-npz"
    out = np.load(io.BytesIO(body))
    assert out["params"].shape == (3, 122)
    assert out["joints_3d"].shape == (3, 42, 3)
    assert out["hand_type"].shape == (3, 2)
    status, js = _post(server.port, "/predict", {"images": imgs.tolist()})
    assert status == 200
    want = np.asarray([r["params"] for r in js["results"]], np.float32)
    np.testing.assert_allclose(out["params"], want, atol=1e-6)


def test_http_predict_npy_roundtrip(server):
    imgs = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, imgs)
    status, ctype, body = _post_binary(server.port, buf.getvalue(), "application/x-npy")
    assert status == 200 and ctype == "application/x-npz"
    assert np.load(io.BytesIO(body))["params"].shape == (2, 122)
    buf = io.BytesIO()
    np.save(buf, imgs[0])  # one sample, no batch dimension
    status, _, body = _post_binary(server.port, buf.getvalue(), "application/x-npy")
    assert status == 200
    assert np.load(io.BytesIO(body))["params"].shape == (1, 122)


def test_http_predict_raw_bad_length_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post_binary(server.port, b"\x00" * 37, "application/octet-stream")
    assert exc.value.code == 400


def test_bad_sample_fails_its_caller_not_the_broker(predict_fn):
    """A malformed sample fails its own submit/predict call; the broker
    survives and later good requests succeed, even after a ragged batch."""
    b = MicroBatcher(predict_fn, batch_size=2, max_wait_ms=5, input_shape=(64, 64, 3))
    try:
        with pytest.raises(ValueError, match="shape"):
            b.predict(np.zeros((3, 3), np.float32))
        with pytest.raises((TypeError, ValueError)):
            b.predict(np.asarray(object()))  # not numeric
        assert b.predict(np.zeros((64, 64, 3), np.float32))["params"].shape == (122,)
        b2 = MicroBatcher(predict_fn, batch_size=2, max_wait_ms=50)  # no shape check: the broker stacks
        try:
            h_bad = b2.submit(np.zeros((3, 3), np.float32))
            h_bad2 = b2.submit(np.zeros((64, 64, 3), np.float32))
            with pytest.raises(RuntimeError):
                b2.wait(h_bad)
            with pytest.raises(RuntimeError):
                b2.wait(h_bad2)  # same batch, same failure
            assert b2.predict(np.zeros((64, 64, 3), np.float32))["params"].shape == (122,)
        finally:
            b2.stop()
    finally:
        b.stop()


def test_saturation_raises_and_http_503():
    """A full queue rejects at once (ServerSaturated) and HTTP answers 503."""
    release = threading.Event()

    def slow_fn(batch):
        release.wait(10)
        return {"y": np.zeros((batch.shape[0], 1), np.float32)}

    b = MicroBatcher(slow_fn, batch_size=1, max_wait_ms=1, max_queue=2)
    srv = InferenceServer(b, (4, 4, 3))
    srv.start(0)
    try:
        x = np.zeros((4, 4, 3), np.float32)
        handles = [b.submit(x)]  # taken by the broker, blocks in slow_fn
        time.sleep(0.1)
        handles += [b.submit(x), b.submit(x)]  # fills the 2-slot queue
        with pytest.raises(ServerSaturated):
            b.submit(x)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.port, "/predict", {"images": [x.tolist()]})
        assert exc.value.code == 503
        assert b.stats()["rejected"] >= 2
        release.set()
        for h in handles:
            b.wait(h)
    finally:
        release.set()
        srv.stop()


def test_concurrent_load_latency_and_efficiency(server):
    """24 requests from 8 threads all succeed, with bounded p95 and shared batches."""
    lat, errs, lock = [], [], threading.Lock()

    def worker(tid):
        try:
            for j in range(3):
                img = np.full((64, 64, 3), (tid * 3 + j) / 100, np.float32).tolist()
                t0 = time.perf_counter()
                status, body = _post(server.port, "/predict", {"images": [img]})
                dt = time.perf_counter() - t0
                assert status == 200 and len(body["results"]) == 1
                with lock:
                    lat.append(dt)
        except Exception as e:  # surfaced through errs
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    assert len(lat) == 24
    lat.sort()
    p95 = lat[int(0.95 * len(lat)) - 1]
    assert p95 < 10.0, f"p95 latency {p95:.2f}s"
    stats = server.batcher.stats()
    assert stats["batches"] < stats["requests"]
    assert stats["batch_efficiency"] > 0.25


def test_concurrent_requests_share_batches(server):
    """8 parallel single-image requests at batch_size 4: all succeed, fewer than 8 calls."""
    errs = []

    def one(i):
        try:
            img = np.full((64, 64, 3), i / 20, np.float32).tolist()
            status, body = _post(server.port, "/predict", {"images": [img]})
            assert status == 200 and len(body["results"]) == 1
        except Exception as e:  # surfaced through errs
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    stats = server.batcher.stats()
    assert stats["requests"] >= 8
    assert stats["batches"] < stats["requests"]


@pytest.fixture(scope="module")
def predict_pair():
    """JAX's and the port's predict outputs on the same 5 images and weights,
    for fp32 and bf16."""
    rng = np.random.RandomState(0)
    images = rng.rand(5, 64, 64, 3).astype(np.float32)
    mean = jax_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32))
    shapes = jax.eval_shape(FlaxEncoder(arch="resnet18").init, jax.random.PRNGKey(0), jnp.asarray(images), mean)
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes)), rng)
    jmano, mano = jax_synthetic(), synthetic_mano_model(device="cpu")
    out = {}
    for name, jdtype, tdtype in (("fp32", jnp.float32, torch.float32), ("bf16", jnp.bfloat16, torch.bfloat16)):
        jax_fn = jax_predict_fn(FlaxEncoder(arch="resnet18", dtype=jdtype), variables, mean, jmano, 64)
        if name == "bf16":
            # JAX's jitted program, the one free variable of its predict
            # function, compiled to round where flax's casts say
            (cell,) = jax_fn.__closure__
            cell.cell_contents = cell.cell_contents.lower(jnp.asarray(images)).compile(compiler_options=STRICT)
        encoder = encoder_from_jax(variables, arch="resnet18", device="cpu", dtype=tdtype)
        port_fn = build_encoder_predict_fn(encoder, torch.as_tensor(np.asarray(mean)), mano, 64, "cpu")
        with backbone_input_dtypes() as seen:
            ours = port_fn(images)
        out[name] = (jax_fn(images), ours, set(seen))
    return out


def test_predict_matches_jax_fp32(predict_pair):
    ref, ours, dtypes = predict_pair["fp32"]
    assert dtypes == {torch.float32}
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    for k in ref:
        assert allclose_ratio(ours[k], ref[k], **PREDICT_TOL) <= 1.0, k


def test_predict_bf16_within_the_band(predict_pair):
    ref16, ours16, dtypes = predict_pair["bf16"]
    ref32 = predict_pair["fp32"][0]
    assert dtypes == {torch.bfloat16}  # every backbone layer's input
    width = max_gaps(ref16, ref32)
    assert all(w > 0 for w in width.values()), width  # the bf16 program really rounds
    ratios = bf16_band_ratios(ours16, ref16, ref32)
    assert all(r <= BF16_STRICT_BAND for r in ratios.values()), ratios
