"""The port's birds apps (apps/birds.py, apps/birds_stream.py,
apps/web_demo.py and its page under apps/web/) against the JAX package's,
on the CPU (--device cpu), and all 27 programs against the band
fingerprints of tests/test_golden_semantics.py.

Bars: renders through apps.birds.render and the Birds facade at the
SoundEngine's float32 bar (2e-4 of the peak; birds.render's SoundEngine
modes against JAX's float64 render, as in tests/test_torch_soundengine.py)
and the WIND float32 bar (1e-5 RMS-relative); program listings and the web
demo's page exactly JAX's; fingerprints at 1.5 dB (3 dB for 'Small animal eating' through
birds.render, whose master limiter tames it), 1 s renders, seed 32. The
JAX package's own app, facade and web-demo tests also run against the
port (device="cpu"), at their own bars.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import test_apps as jt_apps
import test_facades as jt_facades
import test_web_demo as jt_web
from cpp_audio_tpu.apps import birds as jbirds
from cpp_audio_tpu.apps import birds_stream as jstream
from cpp_audio_tpu.apps import web_demo as jweb
from cpp_audio_tpu.utils import wav as wavio
from cpp_audio_tpu_torch.apps import birds as tbirds
from cpp_audio_tpu_torch.apps import birds_stream as tstream
from cpp_audio_tpu_torch.apps import web_demo as tweb
from cpp_audio_tpu_torch.models import soundengine, voice_presets, wind
from test_golden_semantics import FINGERPRINTS, band_fingerprint
from test_torch_engine_core import OnCPU, on_port
from test_web_demo import StubEngine, _get, demo_server  # noqa: F401 (fixture)
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
SECONDS = 0.2
F32_BAR = 2e-4
RMS_BAR = 1e-5


class _BirdsCli:
    """apps.birds' CLI as the JAX tests call it, with --device cpu."""

    @staticmethod
    def main(argv=None):
        return tbirds.main(list(argv) + ["--device", "cpu"])


# ---- the JAX package's own tests, against the port -------------------------

class TestPortBirdsApp(jt_apps.TestBirdsApp):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_apps, birds_app=_BirdsCli)


class TestPortBirdsStream(jt_facades.TestBirdsStream):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_facades, birds_stream=OnCPU(tstream))


@pytest.fixture()
def port_web(monkeypatch):
    monkeypatch.setattr(jt_web, "web_demo", tweb)


def test_web_static_assets(port_web, demo_server):  # noqa: F811
    jt_web.test_static_assets(demo_server)


def test_web_info_and_chunk_roundtrip(port_web, demo_server):  # noqa: F811
    jt_web.test_info_and_chunk_roundtrip(demo_server)


def test_web_program_change(port_web, demo_server):  # noqa: F811
    jt_web.test_program_change(demo_server)


# ---- direct parity ----------------------------------------------------------

def _jax_render64(mode, program, seconds, seed):
    """JAX's birds.render of a SoundEngine program, rendered in float64."""
    from cpp_audio_tpu.models import soundengine as jse
    from cpp_audio_tpu.models import voice_presets as jvp

    m = jvp.Mode(mode)
    out = np.asarray(jse.render_program(jvp.get_program(m, program), 440.0,
                                        int(seconds * SR), SR, seed=seed, dtype="float64"))
    assert np.abs(out).max() <= 1.0  # no master limiter on these
    return out


@pytest.mark.parametrize("mode,program", [("birds", 0), ("robots", "R2D2"), ("sweep", 1),
                                          ("wind", "Heavy rain"),
                                          ("wind", "Small animal eating")])
def test_render_matches_jax(mode, program):
    """birds.render through the master limiter ('Small animal eating' needs
    it: its raw render exceeds 1)."""
    if mode == "wind":
        want = np.asarray(jbirds.render(mode, program, SECONDS, seed=32))
    else:  # JAX's float32 phase drifts further than the bar (ROADMAP §C)
        want = _jax_render64(mode, program, SECONDS, seed=32)
    got = tbirds.render(mode, program, SECONDS, seed=32, device="cpu")
    assert torch.is_tensor(got) and got.shape == want.shape == (int(SECONDS * SR), 2)
    got = got.numpy()
    assert np.abs(got).max() <= 1.0
    if mode == "wind":
        assert np.sqrt(((got - want) ** 2).mean()) <= RMS_BAR * np.sqrt((want ** 2).mean())
    else:
        assert np.abs(got - want).max() <= F32_BAR * np.abs(want).max()


def test_list_matches_jax(capsys):
    assert tbirds.list_programs() == jbirds.list_programs()
    assert tbirds.main(["--list"]) == 0
    assert capsys.readouterr().out.strip() == jbirds.list_programs()


@pytest.mark.parametrize("mode,program", [("birds", "3"), ("robots", "0"), ("sweep", "Fullrange"),
                                          ("wind", "Light rain")])
def test_cli_one_shot_writes_the_render(tmp_path, mode, program):
    out = tmp_path / f"{mode}.wav"
    assert tbirds.main(["--mode", mode, "--program", program, "--seconds", str(SECONDS),
                        "--seed", "5", "--device", "cpu", str(out)]) == 0
    data, sr = wavio.read_wav(out)
    prog = int(program) if program.isdigit() else program
    want = tbirds.render(mode, prog, SECONDS, seed=5, device="cpu").numpy()
    assert sr == SR and data.shape == want.shape
    np.testing.assert_allclose(data, want, atol=1e-6)
    assert np.abs(data).max() > 1e-5


def test_cli_rejects_a_program_out_of_range():
    with pytest.raises(SystemExit):
        tbirds.main(["--mode", "robots", "--program", "7", "--device", "cpu", "x.wav"])


def test_interactive_session_matches_jax(tmp_path):
    """tests/test_interactive_apps.py:14-41 on the port, with each note's
    WAV against JAX's session on the same script."""
    def session(app, out_dir, **kw):
        stdout = io.StringIO()
        n = app.interactive(mode="birds", program=0, seconds=SECONDS, out_dir=out_dir,
                            stdin=io.StringIO("1\nx\nq\n"), stdout=stdout,
                            sample_rate=SR, seed=3, **kw)
        return n, stdout.getvalue().replace(str(out_dir), "")

    n, said = session(tbirds, tmp_path / "t", device="cpu")
    jn, jsaid = session(jbirds, tmp_path / "j")
    assert n == jn == 3
    assert said == jsaid
    assert "using program" in said and "quitting" in said
    wavs = sorted((tmp_path / "t").glob("note_*.wav"))
    jwavs = sorted((tmp_path / "j").glob("note_*.wav"))
    assert len(wavs) == len(jwavs) == 3
    for w, jw in zip(wavs, jwavs):
        d, _ = wavio.read_wav(w)
        jd, _ = wavio.read_wav(jw)
        assert np.abs(d).max() > 1e-5
        assert np.abs(d - jd).max() <= F32_BAR * np.abs(jd).max()
    d2, _ = wavio.read_wav(wavs[1])
    d3, _ = wavio.read_wav(wavs[2])
    assert np.abs(d2 - d3).max() > 1e-6  # the replay drew a fresh seed


def test_interactive_not_a_number_and_cli(tmp_path, monkeypatch):
    stdout = io.StringIO()
    assert tbirds.interactive(mode="robots", seconds=SECONDS, out_dir=tmp_path / "a",
                              stdin=io.StringIO("zzz\nq\n"), stdout=stdout, device="cpu") == 2
    assert "not a number" in stdout.getvalue()
    monkeypatch.setattr("sys.stdin", io.StringIO("q\n"))
    assert tbirds.main(["--interactive", "--mode", "birds", "--seconds", str(SECONDS),
                        "--out-dir", str(tmp_path / "b"), "--device", "cpu"]) == 0
    assert list((tmp_path / "b").glob("note_*.wav"))


def test_birds_facade_matches_jax():
    """Quanta, a program change and a loop re-render: the same frames as
    the JAX facade; each render is one host buffer."""
    t = tstream.Birds(SR, "birds", render_seconds=SECONDS, device="cpu")
    j = jstream.Birds(SR, "birds", render_seconds=SECONDS)
    for b in (t, j):
        b.note_on(440.0)
    got = [t.process() for _ in range(3)]
    want = [j.process() for _ in range(3)]
    assert isinstance(t._buf, np.ndarray)
    t.use_program(2)
    j.use_program(2)
    n_loop = int(SECONDS * SR) + 1000  # past the buffer's end: a re-render
    got += [t.process(4096), t.process(n_loop)]
    want += [j.process(4096), j.process(n_loop)]
    assert t._seed == j._seed
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_BAR * np.abs(want).max()


def test_web_demo_page_is_the_port_own(port_web):
    page = (tweb._WEB_DIR / "index.html").read_text()
    assert tweb._WEB_DIR.parts[-3:] == ("cpp_audio_tpu_torch", "apps", "web")
    assert page.replace("cpp_audio_tpu_torch", "cpp_audio_tpu") == \
        (jweb._WEB_DIR / "index.html").read_text()
    assert (tweb._WEB_DIR / "birds-worklet-processor.js").read_bytes() == \
        (jweb._WEB_DIR / "birds-worklet-processor.js").read_bytes()


def test_web_demo_serves_the_birds_facade():
    """make_server around the real facade on the CPU: info, a 16384-frame
    chunk equal to the facade's own frames, a program change."""
    eng = tstream.Birds(SR, "wind", render_seconds=SECONDS, device="cpu")
    ref = tstream.Birds(SR, "wind", render_seconds=SECONDS, device="cpu")
    httpd = tweb.make_server(eng, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        st, body = _get(base + "/api/info")
        info = json.loads(body)
        assert st == 200 and info["mode"] == "wind" and info["sample_rate"] == SR
        assert info["programs"] == [p.name for p in voice_presets.PROGRAMS[voice_presets.Mode.WIND]]
        st, body = _get(base + "/api/chunk?n=16384")
        pcm = np.frombuffer(body, np.float32).reshape(-1, 2)
        assert st == 200 and pcm.shape == (16384, 2)
        np.testing.assert_array_equal(pcm, ref.process(16384).astype(np.float32))
        req = urllib.request.Request(base + "/api/program?i=3", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        assert eng._program == 3
        st, body = _get(base + "/api/chunk?n=128")
        assert st == 200 and len(body) == 128 * 2 * 4
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("mode,name", sorted(FINGERPRINTS))
def test_program_fingerprint(mode, name):
    """tests/test_golden_semantics.py:238-256 on the port: every program's
    12-band fingerprint of a 1 s render."""
    if (mode, name) == ("wind", "Small animal eating"):
        out = tbirds.render("wind", name, 1.0, seed=32, device="cpu")
        tol = 3.0
    elif mode == "wind":
        p = voice_presets.get_program(voice_presets.Mode.WIND, name)
        out = wind.render_program(p, SR, SR, seed=32, device="cpu")
        tol = 1.5
    else:
        p = voice_presets.get_program(voice_presets.Mode(mode), name)
        out = soundengine.render_program(p, 440.0, SR, SR, seed=32, pan=0.0,
                                         dtype="float64", device="cpu")
        tol = 1.5
    assert bool(torch.isfinite(out).all())
    fp = band_fingerprint(out.numpy().sum(axis=1))
    np.testing.assert_allclose(fp, FINGERPRINTS[(mode, name)], atol=tol)
