"""Browser front end for offline conversion (port of
``seedvc_tpu/apps/webui.py``), on the standard library's ``http.server``:
upload a source and a reference, set the conversion knobs, get audio back.
VC, SVC (F0) and v2 tabs, served by the port's converters on the card.

    python -m seedvc_tpu_torch.apps.webui --port 7860 --checkpoint-dir ./checkpoints \
        --warm 30:5,10:5 --warm-modes vc,svc,v2

Runs on ``cuda`` unless ``--device cpu`` is given.

Endpoints:
- ``GET  /``             single-page UI (VC / SVC / v2 tabs, example rows)
- ``POST /api/convert``  multipart form -> ``audio/wav`` (stats in headers)
- ``POST /api/convert_stream``  same form -> chunked audio (``stream_format``
  wav, flac or mp3), one chunk per crossfaded piece as the pipeline
  generator yields it
- ``GET  /api/examples`` example audio rows
- ``GET  /examples/<n>`` one example wav
- ``GET  /api/status``   loaded models + config, JSON

Each request runs on its own thread (``ThreadingHTTPServer``). Every call
that touches the card holds ``ConverterRegistry.lock``: the lazy build, the
warm-up, a conversion, and each step of a stream's generator. One card runs
one conversion at a time, and the v2 AR decode captures a CUDA graph on its
first call, which must see no other thread's launches.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
from email.parser import BytesParser
from email.policy import default as email_default
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def parse_multipart(content_type: str, body: bytes) -> dict:
    """Parse a multipart/form-data body into {name: (filename, bytes)}."""
    msg = BytesParser(policy=email_default).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    fields: dict[str, tuple[str | None, bytes]] = {}
    if not msg.is_multipart():
        return fields
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True) or b""
        fields[str(name)] = (part.get_filename(), payload)
    return fields


def _f(fields, name, cast, default):
    if name not in fields:
        return default
    raw = fields[name][1].decode().strip()
    if raw == "":
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on", "t")
    return cast(raw)


def synth_examples() -> dict[str, bytes]:
    """Built-in example rows (reference ``app.py:158-165`` wires
    ``examples/source/*.wav``; without shipped speech audio, synthesize a
    vibrato 'source' and a darker 'reference' so the rows always work)."""
    import numpy as np
    from scipy.io import wavfile

    sr = 22050
    t = np.arange(2 * sr) / sr

    def wav(f0, vibrato):
        phase = 2 * np.pi * (f0 * t + vibrato * np.sin(2 * np.pi * 5 * t))
        wave = 0.4 * np.sin(phase) * (0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t))
        buf = io.BytesIO()
        wavfile.write(buf, sr, (wave * 32767).astype(np.int16))
        return buf.getvalue()

    return {"source_demo.wav": wav(220.0, 2.0),
            "reference_demo.wav": wav(130.0, 0.5)}


def load_examples(examples_dir=None) -> dict[str, bytes]:
    if not examples_dir:
        return synth_examples()
    out = {}
    for name in sorted(os.listdir(examples_dir)):
        if name.lower().endswith(".wav"):
            with open(os.path.join(examples_dir, name), "rb") as f:
                out[name] = f.read()
    return out or synth_examples()


class ConverterRegistry:
    """Lazily builds and caches the converters, one per mode and preset.

    ``device`` defaults to ``cuda`` and raises when there is none; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, checkpoint_dir=None, v2_checkpoint_dir=None,
                 examples_dir=None, device=None):
        import torch

        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ConverterRegistry: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.checkpoint_dir = checkpoint_dir
        self.v2_checkpoint_dir = v2_checkpoint_dir
        self.examples = load_examples(examples_dir)
        self._cache: dict[str, object] = {}
        # Building a converter allocates its weights on the card and
        # conversions launch work there: both hold this lock, so two
        # threads never build one converter twice or interleave launches.
        # Reentrant, so a holder may call get() again.
        self.lock = threading.RLock()

    def get(self, mode: str, preset: str):
        key = f"{mode}:{preset}"
        if key in self._cache:
            return self._cache[key]
        with self.lock:
            return self._build(mode, preset, key)

    def _build(self, mode: str, preset: str, key: str):
        if key in self._cache:  # built while we waited on the lock
            return self._cache[key]
        if mode == "v2":
            from seedvc_tpu_torch.apps.infer_v2 import load_v2_params
            from seedvc_tpu_torch.pipelines.convert_v2 import VoiceConverterV2

            conv = VoiceConverterV2(
                params=load_v2_params(self.v2_checkpoint_dir) or None,
                device=self.device)
        else:
            from seedvc_tpu_torch.core.config import get_preset
            from seedvc_tpu_torch.pipelines.convert import VoiceConverter
            from seedvc_tpu_torch.pipelines.wrapper import load_params_dir

            conv = VoiceConverter(get_preset(preset), device=self.device,
                                  **load_params_dir(self.checkpoint_dir))
        self._cache[key] = conv
        return conv

    def loaded(self) -> list[str]:
        return sorted(self._cache)

    def warm(self, specs: list[tuple[float, float]], modes=("vc",),
             preset: str | None = None) -> dict:
        """Build the converters for ``modes`` (vc: ``whisper_small_wavenet``,
        svc: ``whisper_base_f0_44k``, unless ``preset`` says otherwise; v2)
        and run one silent conversion per distinct ``plan_chunks`` plan of
        the ``(source_s, ref_s)`` specs, so that the first request pays
        neither the kernels' build nor the libraries' set-up. Returns the
        plans warmed, by mode.

        vc and svc warm the converter that their requests use, cached under
        ``v1:<preset>`` (the JAX package's ``warm`` builds a second one
        under ``vc:`` / ``svc:``, which no request reads)."""
        warmed = {}
        for mode in modes:
            if mode == "v2":
                conv = self.get("v2", "v2")
            else:
                conv = self.get("v1", preset or (
                    "whisper_base_f0_44k" if mode == "svc"
                    else "whisper_small_wavenet"))
            with self.lock:
                warmed[mode] = conv.warm(specs)
        return warmed


PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>seedvc_tpu</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:880px;margin:2rem auto;padding:0 1rem;background:#14141f;color:#e8e8f0}
 h1{font-size:1.4rem} .tabs button{margin-right:.5rem;padding:.4rem 1rem;border:1px solid #555;background:#222;color:#eee;border-radius:6px;cursor:pointer}
 .tabs button.active{background:#3a5fcd;border-color:#3a5fcd}
 fieldset{border:1px solid #333;border-radius:8px;margin:1rem 0;padding:1rem}
 label{display:inline-block;min-width:14rem;margin:.25rem 0}
 input[type=number]{width:6rem} .row{margin:.3rem 0}
 #go{padding:.5rem 2rem;font-size:1rem;background:#2f9e44;color:#fff;border:0;border-radius:6px;cursor:pointer}
 #status{margin-left:1rem;color:#aaa} audio{width:100%;margin-top:1rem}
</style></head><body>
<h1>seedvc_tpu — zero-shot voice conversion</h1>
<div class="tabs">
 <button id="tab-vc" class="active" onclick="setMode('vc')">Voice Conversion</button>
 <button id="tab-svc" onclick="setMode('svc')">Singing (SVC / F0)</button>
 <button id="tab-v2" onclick="setMode('v2')">V2 accent &amp; style</button>
</div>
<form id="form">
 <fieldset><legend>Audio</legend>
  <div class="row"><label>Source audio (wav)</label><input type="file" name="source" accept=".wav" required></div>
  <div class="row"><label>Reference voice (wav)</label><input type="file" name="target" accept=".wav" required></div>
  <div class="row" id="examples"></div>
 </fieldset>
 <fieldset><legend>Common</legend>
  <div class="row"><label>Diffusion steps</label><input type="number" name="diffusion_steps" value="25" min="1" max="200"></div>
  <div class="row"><label>Length adjust</label><input type="number" name="length_adjust" value="1.0" step="0.05"></div>
  <div class="row"><label>CFG rate</label><input type="number" name="cfg_rate" value="0.7" step="0.05"></div>
  <div class="row"><label>Stream output (chunked)</label><input type="checkbox" id="stream" checked></div>
  <div class="row"><label>Stream format</label><select name="stream_format"><option value="wav">wav (raw)</option><option value="flac">flac (compressed)</option><option value="mp3">mp3 (needs ffmpeg)</option></select></div>
 </fieldset>
 <fieldset id="f-svc" style="display:none"><legend>F0 (singing)</legend>
  <div class="row"><label>Auto F0 adjust</label><input type="checkbox" name="auto_f0_adjust" checked></div>
  <div class="row"><label>Pitch shift (semitones)</label><input type="number" name="pitch_shift" value="0" step="1"></div>
 </fieldset>
 <fieldset id="f-v2" style="display:none"><legend>V2</legend>
  <div class="row"><label>Convert style/accent (AR)</label><input type="checkbox" name="convert_style" checked></div>
  <div class="row"><label>Anonymize</label><input type="checkbox" name="anonymization_only"></div>
  <div class="row"><label>Intelligibility CFG</label><input type="number" name="intelligibility_cfg_rate" value="0.7" step="0.05"></div>
  <div class="row"><label>Similarity CFG</label><input type="number" name="similarity_cfg_rate" value="0.7" step="0.05"></div>
  <div class="row"><label>Top-p</label><input type="number" name="top_p" value="0.7" step="0.05"></div>
  <div class="row"><label>Temperature</label><input type="number" name="temperature" value="0.7" step="0.05"></div>
  <div class="row"><label>Repetition penalty</label><input type="number" name="repetition_penalty" value="1.5" step="0.1"></div>
 </fieldset>
 <button type="submit" id="go">Convert</button><span id="status"></span>
</form>
<audio id="player" controls style="display:none"></audio>
<script>
let mode='vc';
function setMode(m){mode=m;
 for(const t of ['vc','svc','v2']) document.getElementById('tab-'+t).classList.toggle('active',t===m);
 document.getElementById('f-svc').style.display = m==='svc'?'':'none';
 document.getElementById('f-v2').style.display = m==='v2'?'':'none';}
async function loadExamples(){
 const rows=await (await fetch('/api/examples')).json();
 const div=document.getElementById('examples');
 for(const ex of rows){
  const b=document.createElement('button'); b.type='button';
  b.textContent='Use '+ex.name+' as '+(ex.slot||'source');
  b.onclick=async ()=>{
   const blob=await (await fetch(ex.url)).blob();
   const dt=new DataTransfer();
   dt.items.add(new File([blob], ex.name, {type:'audio/wav'}));
   document.querySelector('input[name='+(ex.slot||'source')+']').files=dt.files;
  };
  div.appendChild(b);
 }
}
loadExamples();
document.getElementById('form').addEventListener('submit', async (e)=>{
 e.preventDefault();
 const fd=new FormData(e.target); fd.set('mode',mode);
 // browsers omit unchecked checkboxes entirely; send explicit 0/1 so
 // default-true options can actually be turned off server-side
 for(const cb of e.target.querySelectorAll('input[type=checkbox]'))
   fd.set(cb.name, cb.checked ? '1' : '0');
 const st=document.getElementById('status'); st.textContent='converting…';
 const stream=document.getElementById('stream').checked;
 const r=await fetch(stream?'/api/convert_stream':'/api/convert',
                     {method:'POST',body:fd});
 if(!r.ok){st.textContent='error: '+await r.text();return;}
 st.textContent=stream?'streaming…':('RTF '+(r.headers.get('X-RTF')||'?'));
 const p=document.getElementById('player');
 p.src=URL.createObjectURL(await r.blob()); p.style.display=''; p.play();
 if(stream) st.textContent='done';
});
</script></body></html>"""


def wav_stream_header(sr: int, bits: int = 16, channels: int = 1) -> bytes:
    """RIFF/WAVE header with unknown (0xFFFFFFFF) sizes for live streaming."""
    import struct

    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sr, byte_rate,
                             block_align, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


class FfmpegMp3Encoder:
    """mp3 chunk encoder through an external ffmpeg binary (the reference
    encodes its stream chunks with pydub->ffmpeg, ``seed_vc_wrapper.py:201``).
    Available only where ffmpeg is on ``PATH``; the built-in compressed
    format is FLAC (``dsp/flac.py``)."""

    def __init__(self, sr: int):
        import shutil
        import subprocess

        exe = shutil.which("ffmpeg")
        if exe is None:
            raise RuntimeError(
                "stream_format=mp3 needs an ffmpeg binary on PATH; "
                "use stream_format=flac (built-in, lossless) or wav")
        self._proc = subprocess.Popen(
            [exe, "-hide_banner", "-loglevel", "error", "-f", "s16le",
             "-ar", str(sr), "-ac", "1", "-i", "pipe:0",
             "-f", "mp3", "-b:a", "128k", "pipe:1"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._out: list[bytes] = []
        self._lock = threading.Lock()

        def drain():
            while True:
                data = self._proc.stdout.read(4096)
                if not data:
                    return
                with self._lock:
                    self._out.append(data)

        self._reader = threading.Thread(target=drain, daemon=True)
        self._reader.start()

    def _take(self) -> bytes:
        with self._lock:
            data = b"".join(self._out)
            self._out.clear()
        return data

    def encode(self, pcm16: bytes) -> bytes:
        self._proc.stdin.write(pcm16)
        self._proc.stdin.flush()
        return self._take()

    def finish(self) -> bytes:
        self._proc.stdin.close()
        self._reader.join(timeout=10)
        self._proc.wait(timeout=10)
        return self._take()


def make_stream_encoder(fmt: str, sr: int):
    """(content_type, header_bytes, encode(pcm16 bytes)->bytes,
    finish()->bytes) for a streaming format.  Raises ValueError/RuntimeError
    for unknown/unavailable formats — callers surface a 400 BEFORE chunked
    headers go out."""
    if fmt == "wav":
        return ("audio/wav", wav_stream_header(sr),
                lambda pcm: pcm, lambda: b"")
    if fmt == "flac":
        from seedvc_tpu_torch.dsp.flac import StreamingFlacEncoder

        enc = StreamingFlacEncoder(sr)
        import numpy as np

        return ("audio/flac", enc.header(),
                lambda pcm: enc.encode(np.frombuffer(pcm, "<i2")),
                lambda: b"")
    if fmt == "mp3":
        enc = FfmpegMp3Encoder(sr)
        return ("audio/mpeg", b"", enc.encode, enc.finish)
    raise ValueError(f"unknown stream_format '{fmt}' (wav|flac|mp3)")


class Handler(BaseHTTPRequestHandler):
    server_version = "seedvc_tpu_torch"
    protocol_version = "HTTP/1.1"  # chunked transfer-encoding for streaming

    @property
    def registry(self) -> ConverterRegistry:
        return self.server.registry  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:  # type: ignore[attr-defined]
            sys.stderr.write(fmt % args + "\n")

    def _send(self, code: int, body: bytes, ctype: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/status":
            body = json.dumps({
                "loaded": self.registry.loaded(),
                "checkpoint_dir": self.registry.checkpoint_dir,
            }).encode()
            self._send(200, body, "application/json")
        elif self.path == "/api/examples":
            names = sorted(self.registry.examples)
            rows = [{"name": n, "url": f"/examples/{n}",
                     "slot": ("target" if "ref" in n.lower() else "source")}
                    for n in names]
            self._send(200, json.dumps(rows).encode(), "application/json")
        elif self.path.startswith("/examples/"):
            name = os.path.basename(self.path[len("/examples/"):])
            data = self.registry.examples.get(name)
            if data is None:
                self._send(404, b"no such example", "text/plain")
            else:
                self._send(200, data, "audio/wav")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path not in ("/api/convert", "/api/convert_stream"):
            self._send(404, b"not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            fields = parse_multipart(self.headers.get("Content-Type", ""),
                                     self.rfile.read(length))
        except Exception as e:  # surfaced to the browser
            self._send(400, f"{type(e).__name__}: {e}".encode(), "text/plain")
            return
        if self.path == "/api/convert_stream":
            # handles its own errors: once chunked headers are out, a 400
            # body would corrupt the chunk framing — it closes instead.
            self._convert_stream(fields)
            return
        try:
            wav_bytes, stats = self._convert(fields)
        except Exception as e:
            self._send(400, f"{type(e).__name__}: {e}".encode(), "text/plain")
            return
        self._send(200, wav_bytes, "audio/wav", headers=[
            ("X-RTF", f"{stats.get('rtf', 0):.4f}"),
            ("X-Stats", json.dumps(stats)),
        ])

    # ------------------------------------------------------------------
    def _parse_request(self, fields: dict):
        """Common request parsing: returns (mode, conv, call_kwargs, audio)."""
        import numpy as np
        from scipy.io import wavfile

        for req in ("source", "target"):
            if req not in fields or not fields[req][1]:
                raise ValueError(f"missing '{req}' audio upload")

        def read_wav(data: bytes):
            sr, arr = wavfile.read(io.BytesIO(data))
            if arr.dtype == np.int16:
                wave = arr.astype(np.float32) / 32768.0
            elif arr.dtype == np.int32:
                wave = arr.astype(np.float32) / 2147483648.0
            else:
                wave = arr.astype(np.float32)
            if wave.ndim == 2:
                wave = wave.mean(axis=1)
            return wave, sr

        src, src_sr = read_wav(fields["source"][1])
        ref, ref_sr = read_wav(fields["target"][1])

        mode = _f(fields, "mode", str, "vc")
        steps = _f(fields, "diffusion_steps", int, 25)
        length_adjust = _f(fields, "length_adjust", float, 1.0)
        seed = _f(fields, "seed", int, 0)

        if mode == "v2":
            conv = self.registry.get("v2", "v2")
            kwargs = dict(
                convert_style=_f(fields, "convert_style", bool, True),
                anonymization_only=_f(fields, "anonymization_only", bool,
                                      False),
                diffusion_steps=steps,
                length_adjust=length_adjust,
                intelligibility_cfg_rate=_f(
                    fields, "intelligibility_cfg_rate", float, 0.7),
                similarity_cfg_rate=_f(
                    fields, "similarity_cfg_rate", float, 0.7),
                top_p=_f(fields, "top_p", float, 0.7),
                temperature=_f(fields, "temperature", float, 0.7),
                repetition_penalty=_f(fields, "repetition_penalty", float,
                                      1.5),
                seed=seed)
        else:
            # SVC uses the F0-conditioned 44.1 kHz preset (app_svc.py);
            # plain VC the 22.05 kHz whisper-small one (app_vc.py).
            default_preset = ("whisper_base_f0_44k" if mode == "svc"
                              else "whisper_small_wavenet")
            preset = _f(fields, "preset", str, default_preset)
            conv = self.registry.get("v1", preset)
            kwargs = dict(
                diffusion_steps=steps,
                length_adjust=length_adjust,
                cfg_rate=_f(fields, "cfg_rate", float, 0.7),
                auto_f0_adjust=_f(fields, "auto_f0_adjust", bool, True),
                pitch_shift=_f(fields, "pitch_shift", float, 0.0),
                seed=seed)
        return mode, conv, kwargs, (src, src_sr, ref, ref_sr)

    def _convert(self, fields: dict) -> tuple[bytes, dict]:
        import numpy as np
        from scipy.io import wavfile

        mode, conv, kwargs, audio = self._parse_request(fields)
        with self.registry.lock:
            if mode == "v2":
                sr, out, stats = conv.convert_voice(*audio, **kwargs)
            else:
                sr, out, stats = conv.convert(*audio, **kwargs)

        buf = io.BytesIO()
        wavfile.write(buf, sr, (np.clip(out, -1, 1) * 32767).astype(np.int16))
        return buf.getvalue(), stats

    def _convert_stream(self, fields: dict):
        """Chunked compressed/raw audio response: one HTTP chunk per
        crossfaded pipeline piece (the reference streams mp3 chunks from the
        same kind of generator, ``seed_vc_wrapper.py:201-286``).
        ``stream_format``: wav (raw PCM), flac (built-in lossless
        compression, ``dsp/flac.py``), mp3 (external ffmpeg)."""
        import numpy as np

        try:
            mode, conv, kwargs, audio = self._parse_request(fields)
            fmt = _f(fields, "stream_format", str, "wav")
            # validate the format (incl. ffmpeg availability for mp3) BEFORE
            # chunked headers go out, so failures are clean 400s
            ctype, header, encode, finish = make_stream_encoder(
                fmt, int(getattr(conv, "sr", 22050)))
            gen_fn = (conv.convert_voice_with_streaming if mode == "v2"
                      else conv.convert_with_streaming)
            gen = gen_fn(*audio, **kwargs)
        except Exception as e:
            self._send(400, f"{type(e).__name__}: {e}".encode(), "text/plain")
            return

        def write_chunk(data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def send_stream_headers():
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            if header:
                write_chunk(header)

        # Chunk writes happen while holding the device lock (the generator
        # owns device state between pieces); a stalled reader must not block
        # every other request forever — bound socket writes.
        self.connection.settimeout(30.0)
        headers_sent = False
        with self.registry.lock:
            try:
                for sr, piece, stats in gen:
                    if not headers_sent:
                        send_stream_headers()
                        headers_sent = True
                    pcm = (np.clip(piece, -1, 1) * 32767).astype("<i2")
                    if pcm.size:
                        out = encode(pcm.tobytes())
                        if out:  # a zero-length chunk IS the terminator
                            write_chunk(out)
            except Exception as e:
                if not headers_sent:
                    self._send(400, f"{type(e).__name__}: {e}".encode(),
                               "text/plain")
                    return
                # mid-stream: a 400 body here would land inside the chunked
                # framing — just drop the connection so the client sees a
                # clean truncation.
                self.close_connection = True
                self.log_error("stream aborted: %s: %s", type(e).__name__, e)
                return
            finally:
                # a stream cut short leaves the generator suspended: close it
                # here, under the lock, not on another thread when collected
                gen.close()
        if not headers_sent:
            # valid request but zero pieces (e.g. sub-chunk-length source):
            # well-formed empty audio, not raw chunk bytes with no headers.
            send_stream_headers()
        tail = finish()
        if tail:
            write_chunk(tail)
        self.wfile.write(b"0\r\n\r\n")


def make_server(host: str, port: int, registry: ConverterRegistry,
                verbose: bool = False) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), Handler)
    server.registry = registry  # type: ignore[attr-defined]
    server.verbose = verbose  # type: ignore[attr-defined]
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch web UI")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="converted v1 .pkl parameter trees")
    ap.add_argument("--v2-checkpoint-dir", default=None)
    ap.add_argument("--examples-dir", default=None,
                    help="dir of example wavs for the UI rows (reference "
                         "app.py:158-165; synthesized demos without it)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--warm", default=None, metavar="SPECS",
                    help="warm up before serving: comma-separated src_s:ref_s "
                         "pairs, e.g. '30:5,10:5,5:3'; one silent conversion "
                         "per distinct (context, W) plan builds the kernels "
                         "(nvcc at first use) and sets up cuDNN/cuBLAS and "
                         "the device tables, so the first request pays none "
                         "of it")
    ap.add_argument("--warm-modes", default="vc",
                    help="comma-separated modes to warm (vc,svc,v2)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if not args.checkpoint_dir:
        print("[warn] no --checkpoint-dir: models run with RANDOM weights",
              file=sys.stderr)
    registry = ConverterRegistry(args.checkpoint_dir, args.v2_checkpoint_dir,
                                 examples_dir=args.examples_dir,
                                 device=args.device)
    if args.warm:
        specs = [tuple(float(x) for x in pair.split(":"))
                 for pair in args.warm.split(",")]
        t0 = time.time()
        plans = registry.warm(specs, modes=tuple(args.warm_modes.split(",")))
        print(f"warmed {len(specs)} spec(s) for modes [{args.warm_modes}] in "
              f"{time.time() - t0:.1f} s: plans {json.dumps(plans)}", flush=True)
    server = make_server(args.host, args.port, registry, args.verbose)
    print(f"serving on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
