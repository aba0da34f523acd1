"""The port's tune app, its event streams and scores, apps.wav_tools and
apps.test_fft against the JAX package's, on the CPU (--device cpu).

Bars: the host copies (event streams, scores, scales, pitch generators,
channel requests, WIR files, wav_tools) give exactly JAX's results. Renders
through the harmonics synth (the tune app always low-passes) at atol 1e-4,
the FFT cascade's bar (tests/test_torch_filters.py); the sampler at float32
at atol 1e-6 (tests/test_torch_sampler.py). Preset files are written into a
temporary directory (tests/test_torch_harmonics.write_presets' contents).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

from cpp_audio_tpu.apps import tune as japp
from cpp_audio_tpu.apps import wav_tools as jwt
from cpp_audio_tpu.utils import event_streams as jes
from cpp_audio_tpu.utils import pitch_generators as jpg
from cpp_audio_tpu.utils import scales as jsc
from cpp_audio_tpu.utils import score as jscore
from cpp_audio_tpu.utils import wav as wavio
from cpp_audio_tpu_torch.apps import test_fft as tfft
from cpp_audio_tpu_torch.apps import tune as tapp
from cpp_audio_tpu_torch.apps import wav_tools as twt
from cpp_audio_tpu_torch.utils import event_streams as tes
from cpp_audio_tpu_torch.utils import pitch_generators as tpg
from cpp_audio_tpu_torch.utils import scales as tsc
from cpp_audio_tpu_torch.utils import score as tscore
from cpp_audio_tpu_torch.utils import wir as twir
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
HARMONICS_BAR = 1e-4
SAMPLER_BAR = 1e-6
SCORE = "do mi sol Do- si. la# sol- fab mi re do--"


def _write_presets(d):
    (d / "EnvelopeFast.txt").write_text("A .\nH .\nD ..\nS ....\nR ....\n")
    (d / "Harmonics.txt").write_text("\n".join("." * k for k in (5, 2, 0, 2, 0, 1, 0, 3)) + "\n")
    (d / "LowPass.txt").write_text("800\n")
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = _write_presets(tmp_path_factory.mktemp("tune"))
    rng = np.random.default_rng(5)
    (d / "blob.bin").write_bytes(rng.integers(0, 256, 24, dtype=np.uint8).tobytes())
    t = np.arange(int(0.5 * SR)) / SR
    pluck = np.sin(2 * np.pi * 440.0 * t) * np.exp(-6.0 * t)
    wavio.write_wav(d / "pluck.wav", np.concatenate([np.zeros(300), pluck]), SR)
    return d


def _fields(notes):
    return [dataclasses.astuple(n) for n in notes]


def test_event_streams_are_jax_copies():
    blob = np.random.default_rng(0).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    blob += bytes([7]) * 30 + bytes(range(200))
    for name, kw in (("rain_notes", dict(duration_seconds=4.0, seed=3)),):
        assert _fields(getattr(tes, name)(**kw)) == _fields(getattr(jes, name)(**kw))
    assert _fields(tes.binary_sonification_notes(blob)) == _fields(
        jes.binary_sonification_notes(blob))
    for poly, kw in ((1, {}), (3, dict(pitch_min=40.0, pitch_max=70.0,
                                       uniform_cycle_initialization=False))):
        a = tes.binary_sonification_notes_full(blob, polyphony=poly, batch_size=500, **kw)
        b = jes.binary_sonification_notes_full(blob, polyphony=poly, batch_size=500, **kw)
        assert len(a) > 100 and _fields(a) == _fields(b)
    base_t, base_j = tes.rain_notes(1.0, seed=1), jes.rain_notes(1.0, seed=1)
    assert _fields(tes.loop_notes(base_t, 3, 50000, pitch_offset_per_iteration=2.0)) == \
        _fields(jes.loop_notes(base_j, 3, 50000, pitch_offset_per_iteration=2.0))
    assert _fields(tes.modulo_pitch_notes(base_t)) == _fields(jes.modulo_pitch_notes(base_j))
    assert _fields(tes.loop_from_binary(blob, n_iterations=2, polyphony=2)) == \
        _fields(jes.loop_from_binary(blob, n_iterations=2, polyphony=2))
    assert tes.compute_skip_ranges(np.frombuffer(blob, np.uint8), 11) == [
        tes.ByteRange(r.begin, r.end)
        for r in jes.compute_skip_ranges(np.frombuffer(blob, np.uint8), 11)]


def test_scores_are_jax_copies():
    a, b = tscore.parse_music(SCORE), jscore.parse_music(SCORE)
    assert [(int(s.note) if s.note is not None else None, s.loud, s.duration) for s in a] == \
        [(int(s.note) if s.note is not None else None, s.loud, s.duration) for s in b]
    kw = dict(sample_rate=SR, time_unit_ms=120.0, octave=3)
    assert _fields(tscore.notespecs_to_notes(a, **kw)) == _fields(
        jscore.notespecs_to_notes(b, **kw))
    assert _fields(tapp.score_to_notes(SCORE)) == _fields(japp.score_to_notes(SCORE))
    ra = tscore.notespecs_to_requests(a, **kw)
    rb = jscore.notespecs_to_requests(b, **kw)
    assert len(ra) == len(rb) == len(a)
    for x, y in zip(ra, rb):
        assert x.length == y.length
        np.testing.assert_array_equal(x.buffer, y.buffer)
        np.testing.assert_array_equal(x.volumes, y.volumes)


def test_scales_and_pitch_generators_are_jax_copies():
    np.testing.assert_array_equal(tsc.just_major_scale_asc(), jsc.just_major_scale_asc())
    np.testing.assert_array_equal(tsc.pythagorean_major_scale_asc(),
                                  jsc.pythagorean_major_scale_asc())
    np.testing.assert_array_equal(tsc.to_midi_pitches(48.0, (0, 2, 4, 7)),
                                  jsc.to_midi_pitches(48.0, (0, 2, 4, 7)))
    assert [n for n in vars(tpg) if not n.startswith("_")] == \
        [n for n in vars(jpg) if not n.startswith("_")]


@pytest.mark.parametrize("synth", ["default", "preset"])
def test_render_score_matches_jax(files, synth):
    """2 s of a score through the harmonics synth, both packages."""
    sd = None if synth == "default" else str(files)
    got, sr = tapp.render_score("do mi sol fa la", synth_dir=sd, time_unit_ms=150.0,
                                device="cpu")
    ref, sr2 = japp.render_score("do mi sol fa la", synth_dir=sd, time_unit_ms=150.0)
    ref = np.asarray(ref)
    assert sr == sr2 == SR and got.shape == ref.shape and got.shape[0] > 1.5 * SR
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=HARMONICS_BAR)


MODES = {
    "score": ["do re mi-- fa", "{out}", "--time-unit-ms", "120"],
    "score --synth-dir": ["do re mi-- fa", "{out}", "--synth-dir", "{d}"],
    "--demo": ["--demo", "{out}"],
    "--rain": ["--rain", "0.5", "{out}", "--synth-dir", "{d}"],
    "--sonify": ["--sonify", "{d}/blob.bin", "{out}"],
    "--sonify-full": ["--sonify", "{d}/blob.bin", "{out}", "--sonify-full",
                      "--polyphony", "2", "--loop", "2", "--modulo-pitch"],
    "--sample": ["do mi sol", "{out}", "--sample", "440={d}/pluck.wav",
                 "--synth-dir", "{d}"],
    "--score2": ["do mi", "{out}", "--score2", "sol si", "--octave2", "3",
                 "--loop", "2", "--loop-pitch-offset", "2"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_mode_matches_jax(files, tmp_path, mode):
    """Each mode writes its WAV with --device cpu, equal to JAX's."""
    outs = {}
    for tag, main, extra in (("jax", japp.main, []), ("port", tapp.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.wav"
        argv = [a.format(out=out, d=files) for a in MODES[mode]] + extra
        with contextlib.redirect_stdout(io.StringIO()) as text:
            assert main(argv) == 0
        assert text.getvalue().strip() == f"wrote {out}"
        outs[tag] = wavio.read_wav(out)
    (x, sra), (y, srb) = outs["jax"], outs["port"]
    assert sra == srb == SR and x.shape == y.shape and np.abs(x).max() > 1e-3
    bar = SAMPLER_BAR if mode == "--sample" else HARMONICS_BAR
    np.testing.assert_allclose(y, x, rtol=0, atol=bar)


def test_play_streaming_reloads_like_jax(tmp_path):
    """--play's block streaming: one preset edit mid-piece gives one reload
    in both packages and the same streamed WAV."""
    res = {}
    for tag, app in (("jax", japp), ("port", tapp)):
        d = tmp_path / tag
        d.mkdir()
        _write_presets(d)
        notes = app.score_to_notes("do mi sol do", sample_rate=SR, time_unit_ms=250.0)
        edited = []

        def on_block(bi, t, d=d, edited=edited):
            if not edited and t > SR // 2:
                (d / "Harmonics.txt").write_text("--------\n")
                edited.append(bi)

        kw = {} if tag == "jax" else {"device": "cpu"}
        reloads, total = app.play_streaming(notes, d / "hot.wav", synth_dir=d,
                                            sample_rate=SR, block_seconds=0.1,
                                            on_block=on_block, **kw)
        res[tag] = (reloads, total, edited, wavio.read_wav(d / "hot.wav")[0])
    assert res["port"][:3] == res["jax"][:3] and res["port"][0] == 1
    np.testing.assert_allclose(res["port"][3], res["jax"][3], rtol=0, atol=HARMONICS_BAR)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        assert tapp.main(["do mi", str(tmp_path / "p.wav"), "--synth-dir",
                          str(tmp_path / "port"), "--play", "--device", "cpu"]) == 0
    assert "0 preset reloads" in text.getvalue()


class TestWavTools:
    """tests/test_apps.py:13-58 on the port's copies, each output equal to
    JAX's."""

    def _mk(self, tmp_path, data, name="in.wav"):
        p = tmp_path / name
        wavio.write_wav(p, data, SR, bits=64)
        return p

    def test_count_channels(self, tmp_path):
        p = self._mk(tmp_path, np.zeros((100, 2)))
        assert twt.count_channels(p) == jwt.count_channels(p) == 2

    @pytest.mark.parametrize("tool", ["join_non_zeros", "mod_wav", "self_convolve_wav"])
    def test_tools_match_jax(self, tmp_path, tool):
        rng = np.random.default_rng(3)
        d = rng.standard_normal((400, 2)) * 0.3
        d[50:120] = 0.0
        outs = []
        for tag, mod in (("jax", jwt), ("port", twt)):
            p = self._mk(tmp_path, d, f"{tag}.wav")
            outs.append(wavio.read_wav(getattr(mod, tool)(p)))
        (x, sra), (y, srb) = outs
        assert sra == srb == SR and x.shape == y.shape
        np.testing.assert_array_equal(y, x)
        if tool == "join_non_zeros":
            assert len(y) == 330
        if tool == "self_convolve_wav":
            assert np.max(np.abs(y)) == pytest.approx(1.0, abs=1e-5)

    def test_wir_roundtrip(self, tmp_path):
        rng = np.random.default_rng(2)
        ir = rng.standard_normal((300, 2)).astype(np.float32).astype(np.float64)
        w = tmp_path / "impulse.wir"
        twir.write_wir(w, ir, 48000)
        data, sr = twir.read_wir(w)
        assert sr == 48000
        np.testing.assert_allclose(data, ir, atol=1e-7)
        out = twt.wir_2_wav(w)
        back, sr2 = wavio.read_wav(out)
        assert sr2 == 48000
        np.testing.assert_allclose(back, ir, atol=1e-7)

    def test_main(self, tmp_path, capsys):
        p = self._mk(tmp_path, np.zeros((10, 3)))
        assert twt.main(["count_channels", str(p)]) == 0
        assert capsys.readouterr().out.strip() == "3"
        assert twt.main([]) == 1


def test_test_fft_main_runs(capsys):
    assert tfft.main(["--taps-exp-max", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FIR taps = 63" in out and "FIR taps = 127" in out
