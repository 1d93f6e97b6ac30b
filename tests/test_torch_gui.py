"""The port's GUI server (``rumpy_tpu_torch/gui/``) on the CPU against the
JAX package's (``rumpy_tpu/gui/server.py``), and its PNG codec against
Pillow.

Both servers run on free localhost ports with the same JAX-written EDSR
experiment. Every route answers as the JAX server does: the JSON of
``/test_page``, ``/models`` and ``/update_model``, the page at "/", the 404
of an unknown route and the 500 of a server with no model. The
super-resolved PNGs agree within 1 level (a float32 forward in each
package, rounded to uint8); the port's bicubic route is Pillow's resize
bit for bit, the JAX one's float32 resize within 1 level of it. The codec
writes PNGs Pillow reads back exactly under each of the five filters and
under libpng's per-row choice, reads rows under mixed filters and Pillow's
grey, grey-alpha, RGB and RGBA PNGs exactly, and refuses palette,
16-bit and interlaced PNGs by name.
"""

import base64
import io
import json
import os
import struct
import threading
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from rumpy_tpu.gui import server as jserver
from rumpy_tpu.interface import SISRInterface as JaxSISRInterface
from rumpy_tpu_torch.gui import server as tserver
from rumpy_tpu_torch.gui.png import PNGError, decode_png, encode_png
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

EDSR = {"scale": 2, "num_features": 8, "num_blocks": 1}


def eval_pairs(root, n=2, scale=2):
    """n HR PNGs (24 x 20) and their Pillow-bicubic LR PNGs, in
    ``root/lr`` and ``root/hr``."""
    rng = np.random.default_rng(3)
    lr_dir, hr_dir = os.path.join(root, "lr"), os.path.join(root, "hr")
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for k in range(n):
        yy, xx = np.mgrid[:24, :20]
        hr = np.clip(128 + 60 * np.sin(xx / (5.0 + k))[..., None] * np.cos(yy / 4.0)[..., None]
                     + 15 * rng.standard_normal((24, 20, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(hr).save(os.path.join(hr_dir, f"im{k}.png"))
        Image.fromarray(hr).resize((20 // scale, 24 // scale), Image.BICUBIC).save(
            os.path.join(lr_dir, f"im{k}.png"))
    return lr_dir, hr_dir


def jax_experiment(model_loc, experiment="exp"):
    """A JAX-written EDSR x2 experiment (seeded init, checkpoint 0, a
    summary.csv naming epoch 0 the best); returns ``model_loc``."""
    iface = JaxSISRInterface(model_loc=str(model_loc), experiment=experiment, mode="train",
                             new_params={"name": "edsr", "internal_params": dict(EDSR)})
    iface.save_metadata()
    iface.save()
    with open(os.path.join(str(model_loc), experiment, "result_outputs", "summary.csv"),
              "w") as f:
        f.write("epoch,val-PSNR\n0,20.5\n")
    return str(model_loc)


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"jax"/"port": (url with the model, url without one)}."""
    root = tmp_path_factory.mktemp("gui")
    model_loc = jax_experiment(root / "Results")
    csv_path = root / "models.csv"
    csv_path.write_text("name,experiment,epoch\ntiny,exp,last\n")
    kw = dict(models_csv=str(csv_path), scale=2)
    made = {"jax": [ThreadingHTTPServer(("127.0.0.1", 0), jserver.make_handler(
                jserver.ModelServer(model_loc, default_model=m, **kw))) for m in ("exp", None)],
            "port": [tserver.make_server(model_loc, 0, default_model=m, device="cpu", **kw)
                     for m in ("exp", None)]}
    yield {k: tuple(_serve(h) for h in v) for k, v in made.items()}
    for v in made.values():
        for h in v:
            h.shutdown()
            h.server_close()


def _call(url, body=None):
    """(status, JSON) of a GET (no body) or a JSON POST."""
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _png_b64(img, mode=None):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _pillow(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _image(seed, shape=(12, 10, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_get_routes_match_jax(servers):
    """``/test_page``, ``/models`` and an unknown route give the JAX JSON
    and status; "/" serves the page, which drives the same routes."""
    for path in ("/test_page", "/models", "/nowhere"):
        got, want = _call(servers["port"][0] + path), _call(servers["jax"][0] + path)
        assert got == want, path
    assert _call(servers["port"][0] + "/nowhere") == (404, {"error": "unknown route"})
    assert _call(servers["port"][0] + "/models")[1] == {"models": ["tiny"]}
    with urllib.request.urlopen(servers["port"][0] + "/") as r:
        page = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/html")
    for word in ("<html", "/super_resolve", "/update_model", "/models", "toDataURL"):
        assert word in page, word


@pytest.mark.parametrize("route", ["super_resolve", "super_resolve_and_crop",
                                   "super_resolve_bicubic", "super_resolve_bicubic_and_crop"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_image_routes_match_jax(servers, route, mode):
    """The same PNG (RGB, or RGBA as a canvas sends it) to both servers:
    the output PNG's shape and pixels (within 1 level), the port's bicubic
    Pillow's bit for bit; a crop selects the input region first."""
    img = _image(5, (12, 10, 4 if mode == "RGBA" else 3))
    body = {"image": _png_b64(img, mode), "metadata": ""}
    rgb = img[..., :3]
    if route.endswith("_and_crop"):
        body.update(x=2, y=3, width=6, height=8)
        rgb = rgb[3:11, 2:8]
    (gs, got), (ws, want) = (_call(f"{servers[k][0]}/{route}", body) for k in ("port", "jax"))
    assert gs == ws == 200, (got, want)
    assert set(got) == set(want) == {"output", "runtime"}
    g, w = _pillow(got["output"]), _pillow(want["output"])
    assert g.shape == w.shape == (2 * rgb.shape[0], 2 * rgb.shape[1], 3)
    assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    if "bicubic" in route:
        pil = Image.fromarray(rgb).resize((2 * rgb.shape[1], 2 * rgb.shape[0]), Image.BICUBIC)
        np.testing.assert_array_equal(g, np.asarray(pil))
        assert got["runtime"] == 0.0
    else:
        assert got["runtime"] > 0


def test_update_model_and_errors_match_jax(servers):
    """A server with no model answers 500 with the JAX message; after
    ``/update_model`` of a registry name it serves, and ``/test_page``
    names the model. An unknown POST route is a 404."""
    body = {"image": _png_b64(_image(6))}
    got, want = (_call(f"{servers[k][1]}/super_resolve", body) for k in ("port", "jax"))
    assert got == want == (500, {"error": "No model loaded; POST /update_model first"})
    got, want = (_call(f"{servers[k][1]}/nope", body) for k in ("port", "jax"))
    assert got == want == (404, {"error": "unknown route"})
    got, want = (_call(f"{servers[k][1]}/update_model", {"model": "tiny"})
                 for k in ("port", "jax"))
    assert got == want == (200, {"status": "ok", "model": "tiny"})
    assert _call(servers["port"][1] + "/test_page") == _call(servers["jax"][1] + "/test_page")
    assert _call(servers["port"][1] + "/test_page")[1]["model"] == "tiny"
    assert _call(f"{servers['port'][1]}/super_resolve", body)[0] == 200


def test_metadata_and_image_helpers_match_jax():
    """The metadata string's parse, a data URL's decode and the rounded
    encode as in the JAX server."""
    for meta in ("", None, "0.4 0.1", "1, 2,3"):
        got = tserver.ModelServer._parse_metadata(meta)
        want = jserver.ModelServer._parse_metadata(meta)
        assert (got is None and want is None) or np.array_equal(got, want)
    b64 = _png_b64(_image(7))
    np.testing.assert_array_equal(tserver.ModelServer._decode_b64(b64),
                                  jserver.ModelServer._decode_b64(b64))
    x = np.random.default_rng(8).random((5, 7, 3)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(_pillow(tserver.ModelServer._encode_b64(x)),
                                  _pillow(jserver.ModelServer._encode_b64(x)))


def test_model_server_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserver.ModelServer(str(tmp_path))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "adaptive"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_encoder_round_trips_through_pillow(channels, filter_type):
    """Every row under one filter type, or each under libpng's choice:
    Pillow and the codec read back the image bit for bit."""
    img = _image(channels * 10 + (5 if filter_type == "adaptive" else filter_type),
                 (9, 13, channels))
    img[2:6, 3:9] = img[2, 3]  # a flat patch: the filters' predictions hit
    data = encode_png(img, filter_type)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decoder_reads_pillow_pngs(mode):
    """Pillow's PNGs (its own filter choice, optimised) decode to Pillow's
    pixels."""
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    img = _image(20 + channels, (31, 17, channels))
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(buf, "PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def _idat_rows(data, shape):
    """The (H, 1 + W * C) filtered rows of a one-IDAT PNG of ``encode_png``."""
    raw = zlib.decompress(data[33 + 8:-12 - 4])
    return np.frombuffer(raw, np.uint8).reshape(shape[0], 1 + shape[1] * shape[2])


@pytest.mark.parametrize("shape", [(40, 17, 3), (17, 40, 4), (1, 9, 3), (9, 1, 4)])
def test_png_decoder_reads_mixed_filter_rows(shape):
    """Row y under filter y % 5 (each row's filtering reads only the image,
    so the rows of five one-filter encodings mix), taller than wide, wider
    than tall, one row and one column: the codec reads Pillow's pixels. A
    photo-like image under libpng's choice (smooth with noise, a band of
    repeated rows) puts its rows under Sub, Up and Paeth, as a browser
    canvas does, and reads back too."""
    img = _image(sum(shape), shape)
    rows = np.stack([_idat_rows(encode_png(img, t), shape) for t in range(5)])
    mixed = rows[np.arange(shape[0]) % 5, np.arange(shape[0])]
    ihdr = struct.pack(">IIBBBBB", shape[1], shape[0], 8, {3: 2, 4: 6}[shape[2]], 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(mixed.tobytes())) + _chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(decode_png(data), img)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = 60 * np.sin(yy[..., None] / 5 + np.arange(shape[2])) + 60 * np.cos(xx[..., None] / 7)
    photo = np.clip(smooth + _image(1, shape) / 32 + 128, 0, 255).astype(np.uint8)
    photo[shape[0] // 3:2 * shape[0] // 3] = photo[shape[0] // 3]
    data = encode_png(photo, "adaptive")
    if min(shape[:2]) > 1:
        assert {1, 2, 4} <= set(_idat_rows(data, shape)[:, 0])
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), photo)
    np.testing.assert_array_equal(decode_png(data), photo)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


@pytest.mark.parametrize("case,message", [
    ("palette", "palette"), ("16-bit", "16-bit"), ("interlaced", "interlaced"),
    ("jpeg", "not a PNG")])
def test_png_decoder_refuses_what_it_does_not_read(case, message):
    """A palette PNG (Pillow's "P" mode), a 16-bit and an interlaced header,
    and a JPEG raise PNGError naming what they are."""
    if case == "palette":
        buf = io.BytesIO()
        Image.fromarray(_image(1, (4, 4, 3))).convert("P").save(buf, "PNG")
        data = buf.getvalue()
    elif case == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(_image(1, (8, 8, 3))).save(buf, "JPEG")
        data = buf.getvalue()
    else:
        depth, interlace = (16, 0) if case == "16-bit" else (8, 1)
        data = (b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, depth, 2, 0, 0, interlace))
                + _chunk(b"IDAT", zlib.compress(bytes(40))) + _chunk(b"IEND", b""))
    with pytest.raises(PNGError, match=message):
        decode_png(data)
    with pytest.raises(PNGError, match=message):
        tserver.ModelServer._decode_b64(base64.b64encode(data).decode())
