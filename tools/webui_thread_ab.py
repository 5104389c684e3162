"""The web UI's threading, A against B on one card, each run in fresh processes.

A: ``seedvc_tpu_torch.apps.webui`` as it is, every conversion on its
   request's handler thread, holding ``ConverterRegistry.lock``.
B: the same server with every card call (the warm-up and each conversion)
   handed to one worker thread that the registry owns, so the warm-up and
   the requests share that thread's cuBLAS/cuDNN handles.

Each process warms ``whisper_small_wavenet`` for 30 s + 5 s and 10 s + 5 s,
sends five 30 s requests in turn (client wall, the stats' wall and the
semantic stage's seconds), then three rounds of two 10 s requests: in turn,
then together from two client threads. The designs alternate ABBAABBA.

    python3 tools/webui_thread_ab.py          # needs one CUDA card
"""
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from seedvc_tpu_torch.apps import webui  # noqa: E402


class DeviceThreadRegistry(webui.ConverterRegistry):
    """Design B: the warm-up runs on the registry's one worker thread."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.device_thread = ThreadPoolExecutor(max_workers=1)

    def warm(self, *args, **kwargs):
        return self.device_thread.submit(super().warm, *args, **kwargs).result()


class DeviceThreadHandler(webui.Handler):
    """Design B: ``/api/convert`` hands its conversion to that thread."""

    def _convert(self, fields):
        import io

        import numpy as np
        from scipy.io import wavfile

        mode, conv, kwargs, audio = self._parse_request(fields)
        fn = conv.convert_voice if mode == "v2" else conv.convert
        sr, out, stats = self.registry.device_thread.submit(
            fn, *audio, **kwargs).result()
        buf = io.BytesIO()
        wavfile.write(buf, sr, (np.clip(out, -1, 1) * 32767).astype(np.int16))
        return buf.getvalue(), stats


def one(design: str) -> dict:
    import torch

    if design == "A":
        reg = webui.ConverterRegistry(device="cuda")
        server = webui.make_server("127.0.0.1", 0, reg)
    else:
        reg = DeviceThreadRegistry(device="cuda")
        server = webui.ThreadingHTTPServer(("127.0.0.1", 0), DeviceThreadHandler)
        server.registry = reg
        server.verbose = False
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    t0 = time.perf_counter()
    reg.warm([(30.0, 5.0), (10.0, 5.0)], modes=("vc",))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    src = cs.synthetic_audio(30.0, 22050, 140.0, seed=61)
    ref = cs.wav_upload(cs.synthetic_audio(5.0, 22050, 220.0, seed=62), 22050)[0]
    fields = {"mode": "vc", "source": ("s.wav", cs.wav_upload(src, 22050)[0]),
              "target": ("r.wav", ref)}

    def post(f):
        r = cs.http_call(port, "POST", "/api/convert", f)
        if r["status"] != 200:
            raise RuntimeError(f"design {design}: status {r['status']}")
        return r

    seq = []
    for _ in range(5):
        r = post(fields)
        st = json.loads(r["headers"]["x-stats"])
        seq.append((r["wall_s"], st["wall_seconds"], st["stages"]["semantic"]["seconds"]))
    src10 = cs.wav_upload(cs.synthetic_audio(10.0, 22050, 160.0, seed=66), 22050)[0]
    pair = [{**fields, "source": ("s.wav", src10), "seed": s} for s in (0, 1)]
    pairs = []
    for _ in range(3):
        alone = sum(post(f)["wall_s"] for f in pair)
        t = time.perf_counter()
        ths = [threading.Thread(target=post, args=(f,)) for f in pair]
        for x in ths:
            x.start()
        for x in ths:
            x.join()
        pairs.append((time.perf_counter() - t, alone))
    server.shutdown()
    server.server_close()
    return {"design": design, "warm_s": warm_s, "seq": seq, "pairs": pairs}


def main() -> int:
    card = cs.phase_device()
    cs.phase_build()
    rows = []
    for design in "ABBAABBA":
        p = subprocess.run([sys.executable, os.path.abspath(__file__), design],
                           capture_output=True, text=True, timeout=300, cwd=ROOT)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            print(p.stdout[-3000:], p.stderr[-3000:])
            return 1
        row = json.loads(line[0][len("RESULT "):])
        rows.append(row)
        cs.log(f"{design}: warm {row['warm_s']:.3f} s; 30 s requests (client, stats, "
               "semantic) " + str([tuple(round(v, 3) for v in s) for s in row["seq"]])
               + "; pairs (together, in turn) "
               + str([tuple(round(v, 3) for v in q) for q in row["pairs"]]))
    for d in "AB":
        mine = [r for r in rows if r["design"] == d]
        first = sorted(round(r["seq"][0][0], 3) for r in mine)
        later = sorted(s[0] for r in mine for s in r["seq"][1:])
        ratio = sorted(round(q[0] / q[1], 3) for r in mine for q in r["pairs"])
        sem1 = sorted(round(r["seq"][0][2], 3) for r in mine)
        sem_later = sorted(s[2] for r in mine for s in r["seq"][1:])
        cs.log(f"{d}: first request {first}, later median {later[len(later) // 2]:.3f} "
               f"({later[0]:.3f}-{later[-1]:.3f}); first semantic {sem1}, later median "
               f"{sem_later[len(sem_later) // 2]:.3f}; pair / in turn {ratio}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        print("RESULT " + json.dumps(one(sys.argv[1])), flush=True)
        sys.exit(0)
    sys.exit(main())
