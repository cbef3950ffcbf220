"""The port's serving front end (``simhand_tpu_torch.serving.embed`` and
``.server``) on the CPU: the device-side preprocess against the JAX
package's, padded batch embedding, the micro-batching HTTP server over the
port's bf16 folded walk (``device="cpu"``; kernel #12's blocks take their
plain version there), and the entry points over a float32 ResNet-18
artifact at 32x32: ``embed.main`` over a packed crop cache (against the
artifact on the same preprocessed crops, 1e-4) and over an image glob
(where ``cv2`` imports), and ``server.serve`` on 127.0.0.1. Inputs are made
from a seed with numpy.
"""
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.serving.embed import _preprocess_fn as j_preprocess_fn
from simhand_tpu_torch.models import ContrastiveModel
from simhand_tpu_torch.ops.bottleneck_block import make_folded_encoder_bf16
from simhand_tpu_torch.serving import MicroBatcher, embed_stream, make_handler
from simhand_tpu_torch.serving.embed import _preprocess_fn
from simhand_tpu_torch.serving.server import _nearest_resize

torch.set_num_threads(2)
SIDE = 32


def crops(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("h,w", [(20, 20), (64, 64), (32, 32), (48, 20)],
                         ids=["up-20", "down-64", "same-32", "mixed-48x20"])
def test_preprocess_matches_the_reference(h, w):
    """x / 255, bilinear resize to 32x32, ImageNet normalization. The JAX
    resize widens its triangle filter when it shrinks (antialiasing), which
    F.interpolate does with antialias=True; both renormalize the weights at
    the border. Float32 weights computed in other orders: 1e-5 absolute on
    values of about +-2.6."""
    c = crops(3, h, w)
    want = np.asarray(j_preprocess_fn(SIDE)(jnp.asarray(c)))
    got = _preprocess_fn(SIDE, "cpu")(c)
    assert got.shape == want.shape == (3, SIDE, SIDE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_embed_stream_pads_the_ragged_last_chunk():
    """Seven crops in chunks of three: every call sees the padded batch of
    three, and the rows come back in order without the pad rows."""
    c = crops(7, 20, 20, seed=1)
    seen = []

    def call(x):
        seen.append(tuple(x.shape))
        return {"embedding": x.reshape(x.shape[0], -1)[:, :5] * 2}

    chunks = ((7, c[lo:lo + 3]) for lo in range(0, 7, 3))
    emb = embed_stream(call, chunks, SIDE, 3, "embedding", device="cpu")
    assert seen == [(3, SIDE, SIDE, 3)] * 3
    want = _preprocess_fn(SIDE, "cpu")(c).reshape(7, -1)[:, :5] * 2
    assert emb.dtype == np.float32
    np.testing.assert_array_equal(emb, want.numpy())
    with pytest.raises(ValueError, match="announced"):
        embed_stream(call, ((8, c),), SIDE, 8, "embedding", device="cpu")


def test_microbatcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MicroBatcher(lambda x: {}, SIDE, 8, 5.0)


def test_nearest_resize_matches_the_reference():
    from simhand_tpu.serving.server import _nearest_resize as j_nearest

    for h, w in ((32, 32), (40, 24), (20, 20), (64, 48)):
        img = crops(1, h, w, seed=h)[0]
        np.testing.assert_array_equal(_nearest_resize(img, SIDE), j_nearest(img, SIDE))


def test_microbatch_server_coalesces_requests():
    """Four concurrent HTTP requests of mixed sizes over the ResNet-50 bf16
    walk with layer4_1/2 through the block: each caller gets its own row,
    equal to the direct forward on the same padded, preprocessed batch
    (1e-4, as tests/test_serving.py holds the JAX server)."""
    torch.manual_seed(0)
    model = ContrastiveModel("50").eval()
    forward = make_folded_encoder_bf16(model, ("layer4_1", "layer4_2"))
    batch, sizes = 8, [(32, 32), (40, 24), (20, 20), (64, 48)]
    batcher = MicroBatcher(lambda x: {"embedding": forward(x)}, SIDE, batch, 200.0, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        imgs = [crops(1, h, w, seed=i)[0] for i, (h, w) in enumerate(sizes)]
        results: list = [None] * len(imgs)

        def post(i):
            h, w = sizes[i]
            req = urllib.request.Request(f"http://127.0.0.1:{port}/infer?h={h}&w={w}",
                                         data=imgs[i].tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                results[i] = json.loads(resp.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(imgs))]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 180
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(th.is_alive() for th in threads)

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"

        padded = np.zeros((batch, SIDE, SIDE, 3), np.uint8)
        padded[:len(imgs)] = np.stack([_nearest_resize(img, SIDE) for img in imgs])
        want = forward(_preprocess_fn(SIDE, "cpu")(padded)).numpy()
        for i, res in enumerate(results):
            assert res is not None, f"request {i} failed"
            got = np.asarray(res["embedding"], np.float32)
            assert got.shape == (2048,)
            np.testing.assert_allclose(got, want[i], rtol=1e-4, atol=1e-4)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert not batcher.thread.is_alive()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A float32 ResNet-18 encoder artifact at SIDE, batch-polymorphic."""
    from simhand_tpu_torch.serving.export import build_encoder_forward, export_forward, save_artifact

    torch.manual_seed(1)
    forward = build_encoder_forward(ContrastiveModel("18"))
    path = str(tmp_path_factory.mktemp("serving") / "enc.pt2")
    save_artifact(path, export_forward(forward, side=SIDE, batch="poly"),
                  {"surface": "encoder", "backbone": "18", "side": SIDE})
    return path


def test_embed_main_over_a_crop_cache(artifact, tmp_path):
    """11 cached 64x64 crops in batches of 4 (a ragged last one): the rows
    equal the artifact on the same preprocessed crops within 1e-4."""
    from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache
    from simhand_tpu_torch.data.sources.synthetic import SyntheticHandSource
    from simhand_tpu_torch.serving.embed import main as embed_main
    from simhand_tpu_torch.serving.export import load_artifact

    cache = str(tmp_path / "cache")
    build_crop_cache(SyntheticHandSource(11, side=64, seed=2), cache, shard_size=8)
    out = str(tmp_path / "emb.npy")
    info = embed_main(["--artifact", artifact, "--cache", cache, "--batch", "4",
                       "--device", "cpu", "--out", out])
    emb = np.load(out)
    assert info["shape"] == [11, 512] and emb.shape == (11, 512) and info["images_per_sec"] > 0
    call, _ = load_artifact(artifact, "cpu")
    crops = CachedHand100MSource(cache).gather_crops(np.arange(11))
    want = call(_preprocess_fn(SIDE, "cpu")(crops))["embedding"].numpy()
    np.testing.assert_allclose(emb, want, rtol=1e-4, atol=1e-4)


def test_embed_main_over_an_image_glob(artifact, tmp_path):
    """--images: BGR files decoded to RGB and resized, a ragged last batch,
    the projection written."""
    cv2 = pytest.importorskip("cv2")
    from simhand_tpu_torch.serving.embed import main as embed_main

    rng = np.random.default_rng(7)
    for i in range(5):
        cv2.imwrite(str(tmp_path / f"crop_{i}.png"),
                    rng.integers(0, 255, (20, 20, 3), dtype=np.uint8))
    out = str(tmp_path / "emb.npy")
    embed_main(["--artifact", artifact, "--images", str(tmp_path / "crop_*.png"), "--batch", "2",
                "--what", "projection", "--device", "cpu", "--out", out])
    emb = np.load(out)
    assert emb.shape == (5, 128) and np.isfinite(emb).all()
    assert np.abs(emb[0] - emb[1]).max() > 1e-6


def test_serve_answers_on_localhost(artifact):
    """server.serve on the CPU from the artifact: concurrent requests of
    mixed sizes answered with the artifact's rows (1e-4), /healthz, and a
    clean stop through ready.httpd."""
    from simhand_tpu_torch.serving.export import load_artifact
    from simhand_tpu_torch.serving.server import serve

    ready = threading.Event()
    thread = threading.Thread(target=serve, args=(artifact, 0, 4, 200.0),
                              kwargs={"ready": ready, "device": "cpu"}, daemon=True)
    thread.start()
    assert ready.wait(120)
    port = ready.httpd.server_address[1]
    sizes = [(32, 32), (40, 24), (20, 20)]
    imgs = [crops(1, h, w, seed=10 + i)[0] for i, (h, w) in enumerate(sizes)]
    results: list = [None] * len(imgs)

    def post(i):
        h, w = sizes[i]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/infer?h={h}&w={w}",
                                     data=imgs[i].tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            results[i] = json.loads(resp.read())

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(imgs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not any(th.is_alive() for th in threads)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"
    finally:
        ready.httpd.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    call, _ = load_artifact(artifact, "cpu")
    padded = np.zeros((4, SIDE, SIDE, 3), np.uint8)
    padded[:len(imgs)] = np.stack([_nearest_resize(img, SIDE) for img in imgs])
    want = call(_preprocess_fn(SIDE, "cpu")(padded))
    for i, res in enumerate(results):
        assert res is not None, f"request {i} failed"
        for k in ("embedding", "projection"):
            np.testing.assert_allclose(np.asarray(res[k], np.float32), want[k][i].numpy(),
                                       rtol=1e-4, atol=1e-4)
