"""Browser-runnable birds demo server — the WASM/AudioWorklet deliverable.

The reference ships an actual browser demo: an Emscripten build of the birds
engine loaded into an AudioWorklet (docs/build/emcc.bind.birds.sh,
docs/js/birds.src.js, docs/js/birds-worklet-processor.js,
source/unity.build.birds.lib.cpp:47-240). This module is its runnable
counterpart: a stdlib HTTP server that renders the same SoundEngine programs
through :class:`cpp_audio_tpu_torch.apps.birds_stream.Birds` and streams
interleaved-stereo float32 PCM chunks to a static page
(``apps/web/index.html``) whose AudioWorklet emits the same 128-frame quanta.

Endpoints:
  GET  /                          the demo page
  GET  /birds-worklet-processor.js the worklet module
  GET  /api/info                  {"sample_rate", "mode", "programs": [...]}
  GET  /api/chunk?n=16384         n frames of f32le interleaved stereo PCM
  POST /api/program?i=K           program change (noteOff+noteOn re-render,
                                  reference unity.build.birds.lib.cpp:150-170)

Run: ``python -m cpp_audio_tpu_torch.apps.web_demo [--port 8765] [--mode birds]
[--device cuda]`` (the engine renders on --device, default cuda; each chunk
is served from the engine's host buffer).

Port of cpp_audio_tpu/apps/web_demo.py; its static page is this package's
own copy under apps/web/.
"""

from __future__ import annotations

import argparse
import json
import threading
from http import server
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

_WEB_DIR = Path(__file__).resolve().parent / "web"


class BirdsDemoHandler(server.BaseHTTPRequestHandler):
    """Request handler bound to a shared engine via the server instance."""

    protocol_version = "HTTP/1.1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            self._send(200, (_WEB_DIR / "index.html").read_bytes(),
                       "text/html; charset=utf-8")
        elif url.path == "/birds-worklet-processor.js":
            self._send(200,
                       (_WEB_DIR / "birds-worklet-processor.js").read_bytes(),
                       "text/javascript")
        elif url.path == "/api/info":
            eng = self.server.engine  # type: ignore[attr-defined]
            with self.server.engine_lock:  # type: ignore[attr-defined]
                info = {
                    "sample_rate": eng.sample_rate,
                    "mode": getattr(eng.mode, "value", str(eng.mode)),
                    "programs": self.server.program_names,  # type: ignore
                }
            self._send(200, json.dumps(info).encode(), "application/json")
        elif url.path == "/api/chunk":
            q = parse_qs(url.query)
            n = int(q.get("n", ["16384"])[0])
            n = max(128, min(n, 1 << 20))
            eng = self.server.engine  # type: ignore[attr-defined]
            with self.server.engine_lock:  # type: ignore[attr-defined]
                block = np.asarray(eng.process(n), dtype=np.float32)
            if block.ndim == 1:
                block = np.stack([block, block], axis=1)
            if block.shape[1] == 1:
                block = np.repeat(block, 2, axis=1)
            self._send(200, np.ascontiguousarray(block[:, :2]).tobytes(),
                       "application/octet-stream")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        url = urlparse(self.path)
        if url.path == "/api/program":
            i = int(parse_qs(url.query).get("i", ["0"])[0])
            with self.server.engine_lock:  # type: ignore[attr-defined]
                self.server.engine.use_program(i)  # type: ignore
            self._send(200, b"{}", "application/json")
        else:
            self._send(404, b"not found", "text/plain")

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)


def make_server(engine, host: str = "127.0.0.1", port: int = 8765,
                program_names=None, verbose: bool = False
                ) -> server.ThreadingHTTPServer:
    """Build the demo server around any Birds-shaped engine.

    ``engine`` needs ``sample_rate``, ``mode``, ``process(n) -> (n, 2)``
    and ``use_program(i)`` — the embind surface of the reference's WASM
    class (unity.build.birds.lib.cpp:47-240). Injectable for tests.
    """
    httpd = server.ThreadingHTTPServer((host, port), BirdsDemoHandler)
    httpd.engine = engine
    httpd.engine_lock = threading.Lock()
    httpd.verbose = verbose
    if program_names is None:
        try:
            from ..models import voice_presets
            program_names = [p.name for p in
                             voice_presets.PROGRAMS[engine.mode]]
        except Exception:
            program_names = [f"program {i}"
                             for i in range(engine.max_count_programs())]
    httpd.program_names = program_names
    return httpd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--mode", default="birds",
                    choices=["birds", "robots", "sweep", "wind"])
    ap.add_argument("--sample-rate", type=int, default=44100)
    ap.add_argument("--render-seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine renders on (default cuda)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .birds_stream import Birds

    engine = Birds(sample_rate=args.sample_rate, mode=args.mode,
                   render_seconds=args.render_seconds, device=args.device)
    print(f"# rendering first schedule ({args.mode})…", flush=True)
    engine.process(128)  # warm the first render before accepting clients
    httpd = make_server(engine, args.host, args.port, verbose=args.verbose)
    print(f"# birds demo at http://{args.host}:{args.port}/", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
