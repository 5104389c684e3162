"""The port's web UI (seedvc_tpu_torch/apps/webui.py) against the JAX
package's (seedvc_tpu/apps/webui.py), both served on localhost on the CPU.

- The HTTP surface: JAX's ``FakeConverter`` (tests/test_apps_frontends.py)
  stands in for the converters on both servers, and every request goes to
  both: status, ``Content-Type``, ``Transfer-Encoding``, ``X-RTF``,
  ``X-Stats`` and the body bytes must be identical, and so must the knobs
  each server hands its converter.
- The plain helpers (``parse_multipart``, ``synth_examples``, the stream
  headers) return JAX's bytes.
- ``ConverterRegistry``: ``warm`` forwards the specs for the same presets
  as JAX's, to the converters that the requests use (ROADMAP queue 3: JAX's
  warms a second instance), ``_build`` makes the port's converters on the
  registry's device from the checkpoint directories, and the registry needs
  CUDA unless given ``device="cpu"``.

Real conversions through both servers are in tests/test_torch_webui_convert.py.
Every limit in this file is equality.
"""

import http.client
import json
import pickle
import shutil
import threading

import numpy as np
import pytest
import torch

from seedvc_tpu.apps import webui as jwebui
from seedvc_tpu_torch.apps import webui
from test_apps_frontends import FakeConverter, _multipart, _wav_bytes

torch.set_num_threads(1)


class FakeConverter44(FakeConverter):
    """FakeConverter at the SVC preset's rate: the stream headers take it."""

    sr = 44100


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server), each with FakeConverter for the v1 preset
    and FakeConverter44 for the SVC one."""
    out = []
    for mod, kw in ((jwebui, {}), (webui, {"device": "cpu"})):
        reg = mod.ConverterRegistry(**kw)
        reg._cache["v1:whisper_small_wavenet"] = FakeConverter()
        reg._cache["v1:whisper_base_f0_44k"] = FakeConverter44()
        server = mod.make_server("127.0.0.1", 0, reg)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append(server)
    yield out
    for server in out:
        server.shutdown()
        server.server_close()


def request(server, method, path, body=None, ctype=None):
    """(status, headers that the two servers must share, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        data = resp.read()
        keep = {k: resp.headers.get(k) for k in ("Content-Type", "Content-Length",
                                                   "Transfer-Encoding", "Cache-Control",
                                                   "X-RTF", "X-Stats")}
        return resp.status, keep, data
    finally:
        conn.close()


def _form(n=4410, **fields):
    return {"mode": "vc", "source": ("s.wav", _wav_bytes(n=n)),
            "target": ("r.wav", _wav_bytes()), **fields}


def _post(path, fields):
    body, ctype = _multipart(fields)
    return ("POST", path, body, ctype)


STREAM = "/api/convert_stream"
REQUESTS = {
    "index": lambda: ("GET", "/", None, None),
    "index_html": lambda: ("GET", "/index.html", None, None),
    "status": lambda: ("GET", "/api/status", None, None),
    "examples": lambda: ("GET", "/api/examples", None, None),
    "example_wav": lambda: ("GET", "/examples/source_demo.wav", None, None),
    "example_missing": lambda: ("GET", "/examples/none.wav", None, None),
    "get_not_found": lambda: ("GET", "/api/nothing", None, None),
    "post_not_found": lambda: _post("/api/nothing", _form()),
    "convert_knobs": lambda: _post("/api/convert", _form(diffusion_steps=7, cfg_rate=0.5,
                                                         length_adjust=0.9, seed=3)),
    "svc_knobs": lambda: _post("/api/convert", _form(mode="svc", pitch_shift=-2,
                                                     auto_f0_adjust="on")),
    "svc_auto_f0_off": lambda: _post("/api/convert", _form(mode="svc", auto_f0_adjust="0")),
    "preset_field": lambda: _post("/api/convert", _form(preset="whisper_base_f0_44k")),
    "missing_upload": lambda: _post("/api/convert", {"mode": "vc"}),
    "missing_target": lambda: _post("/api/convert", {"mode": "vc",
                                                     "source": ("s.wav", _wav_bytes())}),
    "bad_number": lambda: _post("/api/convert", _form(diffusion_steps="many")),
    "stream_wav": lambda: _post(STREAM, _form(n=9000, diffusion_steps=5)),
    "stream_flac": lambda: _post(STREAM, _form(n=30000, stream_format="flac")),
    "stream_zero_pieces": lambda: _post(STREAM, _form(n=2)),
    "stream_bad_request": lambda: _post(STREAM, {"mode": "vc"}),
    "stream_svc_wav": lambda: _post(STREAM, _form(n=9000, mode="svc")),
    "stream_svc_flac": lambda: _post(STREAM, _form(n=9000, mode="svc", stream_format="flac")),
    "stream_mp3": lambda: _post(STREAM, _form(n=9000, stream_format="mp3")),
    "stream_unknown_format": lambda: _post(STREAM, _form(stream_format="ogg")),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_http_surface_matches_jax(servers, name):
    method, path, body, ctype = REQUESTS[name]()
    got = []
    for server in servers:
        FakeConverter.calls.clear()
        status, headers, data = request(server, method, path, body, ctype)
        got.append((status, headers, data, list(FakeConverter.calls)))
    (j_status, j_headers, j_data, j_calls), (status, headers, data, calls) = got
    assert (status, headers) == (j_status, j_headers)
    assert data == j_data
    assert calls == j_calls


def test_the_stream_cases_say_what_they_should(servers):
    """The cases above are equal on both sides; these are the properties
    that make them the cases they are named for, on the port."""
    _, server = servers
    status, headers, data = request(server, *REQUESTS["stream_wav"]())
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert data[:4] == b"RIFF" and len(data) == 44 + 2 * 9000
    status, headers, data = request(server, *REQUESTS["stream_zero_pieces"]())
    assert status == 200 and len(data) == 44
    status, _, data = request(server, *REQUESTS["stream_bad_request"]())
    assert status == 400 and b"source" in data
    status, headers, data = request(server, *REQUESTS["stream_mp3"]())
    if shutil.which("ffmpeg") is None:
        assert status == 400 and b"ffmpeg" in data
    else:
        assert status == 200 and headers["Content-Type"] == "audio/mpeg" and data
    # the SVC converter's rate reaches both stream headers
    _, _, data = request(server, *REQUESTS["stream_svc_wav"]())
    assert int.from_bytes(data[24:28], "little") == 44100
    _, _, data = request(server, *REQUESTS["stream_svc_flac"]())
    from seedvc_tpu_torch.dsp.flac import decode_flac

    assert decode_flac(data)[0] == 44100
    status, headers, data = request(server, *REQUESTS["convert_knobs"]())
    assert status == 200 and headers["X-RTF"] == "0.1230"
    assert json.loads(headers["X-Stats"]) == {"rtf": 0.123}


def test_flac_stream_decodes_to_the_wav_stream(servers):
    from seedvc_tpu_torch.dsp.flac import decode_flac

    _, server = servers
    fields = _form(n=30000)
    _, _, wav = request(server, *_post(STREAM, fields))
    _, headers, blob = request(server, *_post(STREAM, {**fields, "stream_format": "flac"}))
    assert headers["Content-Type"] == "audio/flac"
    sr, pcm = decode_flac(blob)
    assert sr == 22050
    np.testing.assert_array_equal(pcm[:, 0], np.frombuffer(wav[44:], "<i2"))
    assert len(blob) < 0.9 * len(wav)


# -- the plain helpers --------------------------------------------------------

def test_parse_multipart_matches_jax():
    body, ctype = _multipart({"mode": "vc", "source": ("s.wav", b"\x00\x01BIN"),
                              "empty": "", "target": ("r.wav", _wav_bytes())})
    fields = webui.parse_multipart(ctype, body)
    assert fields == jwebui.parse_multipart(ctype, body)
    assert fields["source"] == ("s.wav", b"\x00\x01BIN") and fields["mode"] == (None, b"vc")
    assert webui.parse_multipart("text/plain", b"x") == {} == jwebui.parse_multipart(
        "text/plain", b"x")


def test_form_fields_cast_as_jax():
    fields = {"a": (None, b" 3 "), "b": (None, b""), "c": (None, b"On"), "d": (None, b"0.25")}
    for name, cast, default in (("a", int, 0), ("b", int, 7), ("c", bool, False),
                                ("d", float, 1.0), ("z", str, "vc")):
        assert webui._f(fields, name, cast, default) == jwebui._f(fields, name, cast, default)


def test_examples_and_headers_match_jax(tmp_path):
    assert webui.synth_examples() == jwebui.synth_examples()
    assert webui.PAGE == jwebui.PAGE
    (tmp_path / "b_ref.wav").write_bytes(b"R")
    (tmp_path / "a.WAV").write_bytes(b"A")
    (tmp_path / "notes.txt").write_bytes(b"T")
    assert webui.load_examples(str(tmp_path)) == jwebui.load_examples(str(tmp_path))
    assert webui.load_examples(None) == jwebui.synth_examples()
    for sr in (22050, 44100):
        assert webui.wav_stream_header(sr) == jwebui.wav_stream_header(sr)
        for fmt in ("wav", "flac"):
            p, j = webui.make_stream_encoder(fmt, sr), jwebui.make_stream_encoder(fmt, sr)
            assert p[:2] == j[:2]
            pcm = (np.sin(np.arange(5000) / 9.0) * 9000).astype("<i2").tobytes()
            assert p[2](pcm) == j[2](pcm) and p[3]() == j[3]()
    with pytest.raises(ValueError, match="stream_format"):
        webui.make_stream_encoder("ogg", 22050)


# -- ConverterRegistry ----------------------------------------------------------

def test_registry_warm_forwards_specs_as_jax(monkeypatch):
    """tests/test_apps_frontends.py's warm case on both registries: each mode
    gets the specs for the same preset. The port warms the converter that
    the mode's requests use (``v1:<preset>``, as ``_parse_request`` reads
    it); JAX's builds it under the mode's name (``vc:`` / ``svc:``), where
    no request reads it."""
    specs = [(30.0, 5.0), (10.0, 5.0)]
    seen = []
    for mod, kw in ((jwebui, {}), (webui, {"device": "cpu"})):
        calls = []

        class StubConv:
            def __init__(self, mode, preset):
                self.key = (mode, preset)

            def warm(self, specs):
                calls.append((self.key, list(specs)))
                return [self.key[1]]

        reg = mod.ConverterRegistry(**kw)
        monkeypatch.setattr(reg, "get", StubConv)
        out = reg.warm(specs, modes=("vc", "svc", "v2"))
        seen.append(calls)
    j_calls, calls = seen
    assert [(preset, sp) for (_, preset), sp in calls] == [
        (preset, sp) for (_, preset), sp in j_calls]
    assert [key for key, _ in j_calls] == [("vc", "whisper_small_wavenet"),
                                           ("svc", "whisper_base_f0_44k"), ("v2", "v2")]
    assert [key for key, _ in calls] == [("v1", "whisper_small_wavenet"),
                                         ("v1", "whisper_base_f0_44k"), ("v2", "v2")]
    assert all(sp == specs for _, sp in calls)
    assert out == {"vc": ["whisper_small_wavenet"], "svc": ["whisper_base_f0_44k"],
                   "v2": ["v2"]}


def test_registry_warm_takes_a_preset(monkeypatch):
    reg = webui.ConverterRegistry(device="cpu")
    keys = []
    monkeypatch.setattr(reg, "get", lambda mode, preset: keys.append((mode, preset)) or
                        type("C", (), {"warm": lambda self, specs: []})())
    reg.warm([(5.0, 3.0)], modes=("vc", "svc", "v2"), preset="xlsr_tiny")
    assert keys == [("v1", "xlsr_tiny"), ("v1", "xlsr_tiny"), ("v2", "v2")]


def test_warm_then_serve_uses_the_warmed_converter(monkeypatch):
    """After ``warm`` the registry holds one converter a preset, and the
    request is served by the one that was warmed: the conversion and the
    stream on the handler threads, off the thread that warmed."""
    events, threads = [], set()

    class Conv(FakeConverter):
        def __init__(self, key):
            self.key = key

        def warm(self, specs):
            events.append(("warm", self.key))
            threads.add(threading.get_ident())
            return []

        def convert(self, src, src_sr, ref, ref_sr, **kw):
            events.append(("convert", self.key))
            threads.add(threading.get_ident())
            return super().convert(src, src_sr, ref, ref_sr, **kw)

        def convert_with_streaming(self, src, src_sr, ref, ref_sr, **kw):
            threads.add(threading.get_ident())
            yield from super().convert_with_streaming(src, src_sr, ref, ref_sr, **kw)

    reg = webui.ConverterRegistry(device="cpu")
    monkeypatch.setattr(reg, "_build", lambda mode, preset, key: reg._cache.setdefault(
        key, Conv(key)))
    reg.warm([(3.0, 1.0)], modes=("vc", "svc"))
    assert reg.loaded() == ["v1:whisper_base_f0_44k", "v1:whisper_small_wavenet"]
    server = webui.make_server("127.0.0.1", 0, reg)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, _, _ = request(server, *_post("/api/convert", _form(mode="svc")))
        s_status, _, data = request(server, *_post(STREAM, _form(n=900, mode="svc")))
    finally:
        server.shutdown()
        server.server_close()
    assert status == s_status == 200 and len(data) == 44 + 2 * 900
    assert threading.get_ident() in threads and len(threads) >= 2
    assert events == [("warm", "v1:whisper_small_wavenet"), ("warm", "v1:whisper_base_f0_44k"),
                      ("convert", "v1:whisper_base_f0_44k")]
    assert reg.loaded() == ["v1:whisper_base_f0_44k", "v1:whisper_small_wavenet"]


def _held_elsewhere(lock) -> bool:
    """True when another thread cannot take ``lock`` at this moment."""
    took = []

    def take():
        took.append(lock.acquire(blocking=False))
        if took[0]:
            lock.release()

    t = threading.Thread(target=take)
    t.start()
    t.join()
    return not took[0]


def test_registry_warm_holds_the_lock(monkeypatch):
    reg = webui.ConverterRegistry(device="cpu")
    held = []

    class StubConv:
        def warm(self, specs):
            held.append(_held_elsewhere(reg.lock))
            return []

    monkeypatch.setattr(reg, "get", lambda mode, preset: StubConv())
    reg.warm([(1.0, 1.0)], modes=("vc", "v2"))
    assert held == [True, True]


def test_registry_builds_port_converters_from_checkpoints(monkeypatch, tmp_path):
    import seedvc_tpu_torch.pipelines.convert as pconvert
    import seedvc_tpu_torch.pipelines.convert_v2 as pconvert_v2

    built = []

    class V1:
        def __init__(self, cfg, device=None, **params):
            built.append(("v1", cfg.preprocess_params.sr, device, sorted(params)))

    class V2:
        PARAM_NAMES = pconvert_v2.VoiceConverterV2.PARAM_NAMES

        def __init__(self, params=None, device=None):
            built.append(("v2", sorted(params or {}), device))

    monkeypatch.setattr(pconvert, "VoiceConverter", V1)
    monkeypatch.setattr(pconvert_v2, "VoiceConverterV2", V2)
    v1_dir, v2_dir = tmp_path / "v1", tmp_path / "v2"
    v1_dir.mkdir()
    v2_dir.mkdir()
    for path in (v1_dir / "vc.pkl", v1_dir / "vocoder.pkl", v2_dir / "dit.pkl",
                 v2_dir / "ar.pkl"):
        path.write_bytes(pickle.dumps({"w": np.zeros(2, np.float32)}))
    reg = webui.ConverterRegistry(str(v1_dir), str(v2_dir), device="cpu")
    vc = reg.get("v1", "whisper_small_wavenet")
    assert reg.get("v1", "whisper_small_wavenet") is vc
    reg.get("v1", "whisper_base_f0_44k")
    reg.get("v2", "v2")
    assert built == [
        ("v1", 22050, torch.device("cpu"), ["vc_params", "vocoder_params"]),
        ("v1", 44100, torch.device("cpu"), ["vc_params", "vocoder_params"]),
        ("v2", ["ar", "dit"], torch.device("cpu")),
    ]
    assert reg.loaded() == ["v1:whisper_base_f0_44k", "v1:whisper_small_wavenet", "v2:v2"]
    webui.ConverterRegistry(device="cpu").get("v2", "v2")
    assert built[-1] == ("v2", [], torch.device("cpu"))


def test_registry_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        webui.ConverterRegistry()
    assert webui.ConverterRegistry(device="cpu").device.type == "cpu"


def test_main_serves_with_device_cpu(monkeypatch, capsys):
    """``main`` hands ``--device`` and the warm specs to the registry, prints
    its warmed and serving lines, and serves until interrupted."""
    made = {}

    class Reg(webui.ConverterRegistry):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["reg"] = self

        def warm(self, specs, modes=("vc",), preset=None):
            made["warm"] = (specs, modes)
            return {m: [[256, 512, 256]] for m in modes}

    class Server:
        server_address = ("127.0.0.1", 4321)

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            made["shutdown"] = True

    monkeypatch.setattr(webui, "ConverterRegistry", Reg)
    monkeypatch.setattr(webui, "make_server", lambda host, port, reg, verbose: Server())
    webui.main(["--device", "cpu", "--port", "0", "--warm", "10:5,3:2", "--warm-modes",
                "vc,v2"])
    out = capsys.readouterr().out
    assert made["reg"].device.type == "cpu" and made["shutdown"]
    assert made["warm"] == ([(10.0, 5.0), (3.0, 2.0)], ("vc", "v2"))
    assert "warmed 2 spec(s) for modes [vc,v2]" in out and "serving on http://127.0.0.1:4321" in out


class BrokenConverter(FakeConverter):
    """Yields one piece, then fails: the stream is cut mid-way."""

    closed: list = []

    def convert_with_streaming(self, src, src_sr, ref, ref_sr, **kw):
        try:
            yield src_sr, 0.5 * src[:1000], {"rtf": 0.1}
            raise RuntimeError("device lost")
        finally:
            BrokenConverter.closed.append(True)


def test_a_failure_mid_stream_drops_the_connection_as_jax(servers):
    """After the chunked headers a 400 would land inside the framing: both
    servers drop the connection instead, so the client reads a truncated
    stream (the header and the first piece, no terminating chunk)."""
    got = []
    for server in servers:
        server.registry._cache["v1:broken"] = BrokenConverter()
        BrokenConverter.closed.clear()
        with pytest.raises(http.client.IncompleteRead) as exc:
            request(server, *_post(STREAM, _form(preset="broken")))
        got.append(exc.value.partial)
    assert got[0] == got[1] and len(got[1]) == 44 + 2 * 1000
    assert BrokenConverter.closed == [True]  # the port closed it under the lock


class LockProbeConverter(FakeConverter):
    """Records, at a conversion and at each step of a stream, whether another
    thread could take the registry's lock then."""

    held: list = []

    def __init__(self, registry):
        self.registry = registry

    def convert(self, src, src_sr, ref, ref_sr, **kw):
        LockProbeConverter.held.append(_held_elsewhere(self.registry.lock))
        return super().convert(src, src_sr, ref, ref_sr, **kw)

    def convert_with_streaming(self, src, src_sr, ref, ref_sr, **kw):
        for out in super().convert_with_streaming(src, src_sr, ref, ref_sr, **kw):
            LockProbeConverter.held.append(_held_elsewhere(self.registry.lock))
            yield out


def test_conversions_and_stream_steps_hold_the_lock(servers):
    """A conversion and every step of a stream's generator run while no other
    thread can take ``registry.lock``, so no other request's launches (nor
    the v2 AR's graph capture) interleave with them."""
    server = servers[1]
    server.registry._cache["v1:probe"] = LockProbeConverter(server.registry)
    LockProbeConverter.held.clear()
    try:
        assert request(server, *_post("/api/convert", _form(preset="probe")))[0] == 200
        assert request(server, *_post(STREAM, _form(n=9000, preset="probe")))[0] == 200
    finally:
        del server.registry._cache["v1:probe"]
    assert LockProbeConverter.held == [True] * 4
