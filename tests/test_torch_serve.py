"""PyTorch port, serving daemon: the contract of tests/test_serve.py on the
port, asked for the CPU (``--device cpu``).

Drives the real ThreadingHTTPServer end to end on the tiny config: health
check, PNG round trip (decoded with PIL; the port encodes with zlib+struct),
seed determinism, co-batching independence, 400 above ``--batch``, and
``/faces2img`` (live faces through the MetaIdNet) with its bad inputs.
"""
import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import _torch_port_helpers  # noqa: F401  (one PyTorch thread per worker)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    from http.server import ThreadingHTTPServer

    from celebbasis_tpu_torch.cli.serve import (TxtToImgService,
                                                build_argparser, make_handler)
    from celebbasis_tpu_torch.loader import init_weights

    cfg = os.path.join(REPO, "configs", "tiny.yaml")
    args = build_argparser().parse_args([
        "--config", cfg, "--H", "32", "--ddim_steps", "4", "--batch", "2",
        "--precision", "fp32", "--ids", "0", "--device", "cpu",
    ])
    service = TxtToImgService(args)
    # draw the zero-initialised output convs, so that the conditioning (the
    # prompt, the faces) shows in the pixels of this random-weight run
    init_weights(service.asm.pipeline.unet, torch.Generator().manual_seed(5),
                 zero_convs=False)
    service.warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    service.stop()


def _post(url, obj, path="/txt2img"):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _decode(b64):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz") as r:
        h = json.loads(r.read())
    assert h["ok"] and h["warm"] and h["batch"] == 2 and h["device"] == "cpu"
    assert h["attention"] == "xla"      # the CPU's route is the plain core
    assert h["geglu"] == "xla"          # the kernel route is opt-in
    assert h["sampler"] == "ddim"


def test_txt2img_roundtrip_and_determinism(server):
    url, _ = server
    code, a = _post(url, {"prompt": "a photo of a sks person", "seed": 7,
                          "n_samples": 2})
    assert code == 200 and len(a["images"]) == 2 and a["ms"] > 0
    img = _decode(a["images"][0])
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert img.std() > 1

    code, b = _post(url, {"prompt": "a photo of a sks person", "seed": 7,
                          "n_samples": 2})
    assert code == 200
    np.testing.assert_array_equal(_decode(a["images"][0]),
                                  _decode(b["images"][0]))

    code, c = _post(url, {"prompt": "a photo of a sks person", "seed": 8})
    assert code == 200 and len(c["images"]) == 1
    assert np.abs(_decode(c["images"][0]).astype(int)
                  - _decode(a["images"][0]).astype(int)).sum() > 0


def test_bad_requests(server):
    url, _ = server
    code, e = _post(url, {"prompt": "x", "n_samples": 3})
    assert code == 400 and "n_samples" in e["error"]
    code, e = _post(url, {"n_samples": 1})
    assert code == 400
    code, e = _post(url, {"prompt": "x"}, path="/nothing")
    assert code == 404
    with urllib.request.urlopen(url + "/healthz") as r:
        assert json.loads(r.read())["ok"]    # the server survived them


def _png_face(seed, size=24):
    from celebbasis_tpu_torch.cli.serve import encode_png
    img = np.random.default_rng(seed).integers(0, 256, (size, size, 3))
    return base64.b64encode(encode_png(img.astype(np.uint8))).decode()


def test_faces2img_roundtrip(server):
    """Two 24x24 crops (resized to 32 on the device): a 32x32 PNG, the same
    bytes for the same seed, another image for other faces; 400 on an empty
    list, on more faces than placeholder slots and above --batch."""
    url, service = server
    req = {"prompt": "a photo of a sks person and a ks person",
           "faces": [_png_face(1), _png_face(2)], "seed": 5}
    code, a = _post(url, req, path="/faces2img")
    assert code == 200 and len(a["images"]) == 1 and a["ms"] > 0
    img = _decode(a["images"][0])
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert img.std() > 1
    code, b = _post(url, req, path="/faces2img")
    assert code == 200 and b["images"] == a["images"]
    code, c = _post(url, dict(req, faces=[_png_face(3), _png_face(4)]),
                    path="/faces2img")
    assert code == 200 and c["images"] != a["images"]

    for bad in ([], [_png_face(1)] * (service.k + 1)):
        code, e = _post(url, dict(req, faces=bad), path="/faces2img")
        assert code == 400 and "faces" in e["error"]
    code, e = _post(url, dict(req, n_samples=3), path="/faces2img")
    assert code == 400 and "n_samples" in e["error"]
    code, e = _post(url, dict(req, faces=["bm90IGFuIGltYWdl"]),
                    path="/faces2img")
    assert code == 400


def test_concurrent_requests_both_served(server):
    url, service = server
    before = service.requests
    results = []

    def go(seed):
        results.append(_post(url, {"prompt": "a photo of a sks person",
                                   "seed": seed}))

    ts = [threading.Thread(target=go, args=(s,)) for s in (1, 2)]
    [th.start() for th in ts]
    [th.join() for th in ts]
    assert all(code == 200 for code, _ in results)
    assert service.requests == before + 2


def test_continuous_batching_coalesces_and_is_deterministic(server):
    """Two concurrent 1-sample requests run in ONE device call, and each
    request's pixels are identical to what it gets when served alone:
    per-sample generators make results independent of batch composition."""
    url, service = server
    _, solo_a = _post(url, {"prompt": "a photo of a sks person", "seed": 21})
    _, solo_b = _post(url, {"prompt": "a portrait of a sks person",
                            "seed": 22})
    old_window = service.window
    service.window = 1.0          # generous coalescing window for the test
    try:
        calls_before = service.batched_calls
        results = {}

        def go(name, prompt, seed):
            results[name] = _post(url, {"prompt": prompt, "seed": seed})

        ts = [threading.Thread(target=go,
                               args=("a", "a photo of a sks person", 21)),
              threading.Thread(target=go,
                               args=("b", "a portrait of a sks person", 22))]
        [th.start() for th in ts]
        [th.join() for th in ts]
    finally:
        service.window = old_window
    assert all(code == 200 for code, _ in results.values())
    assert service.batched_calls == calls_before + 1, \
        "concurrent requests were not coalesced into one device call"
    np.testing.assert_array_equal(_decode(results["a"][1]["images"][0]),
                                  _decode(solo_a["images"][0]))
    np.testing.assert_array_equal(_decode(results["b"][1]["images"][0]),
                                  _decode(solo_b["images"][0]))


def test_multi_sample_row_matches_single(server):
    """Sample j of a request draws from a generator seeded from (seed, j):
    the first row of an n_samples=2 request equals the lone sample of an
    n_samples=1 request with the same seed."""
    url, _ = server
    _, two = _post(url, {"prompt": "a photo of a sks person", "seed": 33,
                         "n_samples": 2})
    _, one = _post(url, {"prompt": "a photo of a sks person", "seed": 33})
    np.testing.assert_array_equal(_decode(two["images"][0]),
                                  _decode(one["images"][0]))
    assert np.abs(_decode(two["images"][1]).astype(int)
                  - _decode(two["images"][0]).astype(int)).sum() > 0


def test_png_encoder_roundtrip_with_pil():
    from PIL import Image

    from celebbasis_tpu_torch.cli.serve import encode_png
    img = np.random.default_rng(0).integers(0, 256, (19, 23, 3)).astype(
        np.uint8)
    back = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError):
        encode_png(img[:, :, 0])
