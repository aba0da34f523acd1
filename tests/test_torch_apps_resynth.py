"""Every CLI mode of the port's apps.resynth and apps.resynth_ui, run with
--device cpu, against the JAX package's apps on the same input files.

Bars: the printed lines equal JAX's (stats, counts, note lists; the
dashboard's gauge times excepted); output WAVs with a resynthesis or live
leg at max|diff|/peak < 2e-3 (the resynth leg's bar, tests/test_chain.py:83);
vocoder-only WAVs at atol 1e-4 (the vocoded leg's bar); the debug taps
under the same file names; the note-deduction piano roll byte-equal.
"""

import io
import re
import struct
import sys

import numpy as np
import pytest

from cpp_audio_tpu.analysis import presets_json as jpj
from cpp_audio_tpu.apps import resynth as japp
from cpp_audio_tpu.apps import resynth_ui as jui
from cpp_audio_tpu.utils import wav as wavio
from cpp_audio_tpu_torch.apps import resynth as tapp
from cpp_audio_tpu_torch.apps import resynth_ui as tui
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
RESYNTH_BAR = 2e-3
VOCODED_BAR = 1e-4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    t = np.arange(int(0.6 * SR)) / SR
    voice = 0.4 * np.sin(2 * np.pi * 392.0 * t)  # tests/test_apps.py's tone
    wavio.write_wav(d / "in.wav", voice.astype(np.float32), SR)
    wavio.write_wav(d / "car.wav", np.sign(np.sin(2 * np.pi * 110.0 * t)).astype(np.float32), SR)
    # a small SMF: two notes and a pitch-wheel move
    trk = b"\x00\xff\x51\x03" + struct.pack(">I", 500000)[1:]
    for delta, msg in ((0, bytes([0x90, 45, 100])), (120, bytes([0x90, 52, 90])),
                       (120, bytes([0xE0, 0x00, 0x50])), (240, bytes([0x80, 45, 0])),
                       (0, bytes([0x80, 52, 0]))):
        trk += bytes([delta]) if delta < 128 else bytes([0x80 | (delta >> 7), delta & 0x7F])
        trk += msg
    trk += b"\x00\xff\x2f\x00"
    (d / "t.mid").write_bytes(b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480) + b"MTrk"
                              + struct.pack(">I", len(trk)) + trk)
    return d


def _both(capsys, argv_of, tmp_path):
    """Run JAX's and the port's main on argv_of(out_dir); returns
    ((jax_out_dir, jax_text), (port_out_dir, port_text))."""
    res = []
    for tag, main, extra in (("jax", japp.main, []), ("port", tapp.main, ["--device", "cpu"])):
        out = tmp_path / tag
        out.mkdir()
        assert main(argv_of(out) + extra) == 0
        res.append((out, capsys.readouterr().out.replace(str(out), "<out>")))
    return res


def _wavs(a, b, name):
    x, sra = wavio.read_wav(a / name)
    y, srb = wavio.read_wav(b / name)
    assert sra == srb == SR and x.shape == y.shape
    return x, y


def _rel(x, y):
    return float(np.abs(y - x).max()) / max(float(np.abs(x).max()), 1e-12)


def test_plain_resynth(inputs, tmp_path, capsys):
    (jd, jt), (td, tt) = _both(capsys, lambda o: [str(inputs / "in.wav"), str(o / "o.wav")],
                               tmp_path)
    assert jt == tt
    x, y = _wavs(jd, td, "o.wav")
    assert np.abs(x).max() > 1e-2 and _rel(x, y) < RESYNTH_BAR


def test_live(inputs, tmp_path, capsys):
    (jd, jt), (td, tt) = _both(capsys, lambda o: [str(inputs / "in.wav"), str(o / "o.wav"),
                                                  "--live", "--block-size", "1024"], tmp_path)
    assert "live:" in tt and jt == tt
    x, y = _wavs(jd, td, "o.wav")
    assert np.abs(x).max() > 1e-2 and _rel(x, y) < RESYNTH_BAR


def test_live_midi(inputs, tmp_path, capsys):
    (jd, jt), (td, tt) = _both(capsys, lambda o: [
        str(inputs / "in.wav"), str(o / "o.wav"), "--live", "--midi", str(inputs / "t.mid"),
        "--carrier", "saw=0.8,noise=0.2", "--vocoder-volumes", "vocoded=1,carrier=0.1"],
        tmp_path)
    assert "live+midi:" in tt and jt == tt
    x, y = _wavs(jd, td, "o.wav")
    assert x.shape[1] == 2 and np.abs(x).max() > 1e-2 and _rel(x, y) < RESYNTH_BAR


@pytest.mark.parametrize("mode", ["fft", "filterbank"])
def test_vocode_with_debug_taps(inputs, tmp_path, capsys, mode):
    (jd, jt), (td, tt) = _both(capsys, lambda o: [
        str(inputs / "in.wav"), str(o / "o.wav"), "--vocode", str(inputs / "car.wav"),
        "--vocode-mode", mode, "--debug-vocoder", str(o / "taps")], tmp_path)
    assert jt == tt
    x, y = _wavs(jd, td, "o.wav")
    assert np.abs(x).max() > 1e-3
    np.testing.assert_allclose(y, x, rtol=0, atol=VOCODED_BAR)
    names = sorted(p.name for p in (jd / "taps").iterdir())
    assert names == sorted(p.name for p in (td / "taps").iterdir())
    assert "vocoded.wav" in names


def test_deduce(inputs, tmp_path, capsys):
    (jd, jt), (td, tt) = _both(capsys, lambda o: [str(inputs / "in.wav"), str(o / "o.wav"),
                                                  "--deduce"], tmp_path)
    assert re.search(r"\(\d+ notes\)", tt) and jt == tt
    x, y = _wavs(jd, td, "o.wav")
    assert _rel(x, y) < RESYNTH_BAR
    assert (td / "o.notes.bmp").read_bytes() == (jd / "o.notes.bmp").read_bytes()


@pytest.mark.parametrize("checkpoint", [False, True])
def test_job(inputs, tmp_path, capsys, checkpoint):
    preset = jpj.ResynthPreset(analysis_volume=1.0, vocoder_volume=0.7, voice_volume=0.2,
                               carrier_volume=0.1)

    def argv(o):
        preset.save(o / "p.json")
        jpj.OfflineJobConfig(preset_file=str(o / "p.json"),
                             input_voice_file=str(inputs / "in.wav"),
                             input_carrier_file=str(inputs / "car.wav"),
                             output_file=str(o / "o.wav"), post="limit").save(o / "job.json")
        extra = ["--checkpoint", str(o / "ck.bin"), "--checkpoint-seconds", "0.2"]
        return ["--job", str(o / "job.json")] + (extra if checkpoint else [])

    (jd, jt), (td, tt) = _both(capsys, argv, tmp_path)
    assert jt == tt
    x, y = _wavs(jd, td, "o.wav")
    assert np.abs(x).max() > 1e-2 and np.abs(y).max() <= 1.0
    assert _rel(x, y) < RESYNTH_BAR
    assert not (td / "ck.bin").exists()


def _strip_gauges(text):
    return re.sub(r"(?m)^  (\S.{19}) +[0-9.]+ ms$", r"  \1 <ms>", text)


def test_dashboard(inputs, tmp_path, capsys):
    """resynth_ui's report: parameters, pitch window, note counts, vocoder
    band rows; the stage gauges' times are the run's own."""
    out = []
    for main, extra in ((jui.main, []), (tui.main, ["--device", "cpu"])):
        assert main([str(inputs / "in.wav"), "--vocoder", "--width", "60",
                     "--height", "12"] + extra) == 0
        out.append(capsys.readouterr().out)
    assert "pitch window" in out[1] and "vocoder window" in out[1]
    assert "fft+peaks" in out[1] and "vocoder bands" in out[1]
    assert _strip_gauges(out[0]) == _strip_gauges(out[1])


def test_dashboard_live(inputs, monkeypatch, capsys):
    """resynth_ui --live, fed `set`, then `quit` after two refreshes."""
    out = []
    for main, extra in ((jui.main, []), (tui.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO("set min_volume 0.001\nquit\n"))
        assert main([str(inputs / "in.wav"), "--live", "--width", "50"] + extra) == 0
        out.append(capsys.readouterr().out)
    assert "set min_volume = 0.001" in out[1] and "1 commands" in out[1]
    assert out[0] == out[1]


def test_live_dashboard_runs_on_the_given_device(inputs):
    mono, sr = wavio.read_wav(inputs / "in.wav")
    stats = tui.live_dashboard(mono[:, 0], sr, stdin=io.StringIO(""), stdout=io.StringIO(),
                               block_size=4096, blocks_per_refresh=2, device="cpu")
    ref = jui.live_dashboard(mono[:, 0], sr, stdin=io.StringIO(""), stdout=io.StringIO(),
                             block_size=4096, blocks_per_refresh=2)
    assert stats == ref and stats["windows"] > 0


def test_profiling_utilities_match_jax(tmp_path):
    """utils/profiling.py: the host utilities are copies (string_plot's
    text equal to JAX's); device_trace writes a torch.profiler trace."""
    import torch

    from cpp_audio_tpu.utils import profiling as jprof
    from cpp_audio_tpu_torch.utils import profiling as tprof

    v = np.abs(np.sin(np.linspace(0, 9, 300))) + 1e-3
    for kw in (dict(height=8), dict(height=6, width=40, log_y=True)):
        assert tprof.string_plot(v, **kw) == jprof.string_plot(v, **kw)
    stages = tprof.StageDurations()
    with stages.stage("a"):
        pass
    stages.record("a", 0.5)
    assert stages.summary()["a"]["count"] == 2 and stages.last("a") == 0.5
    got = []
    log = tprof.AsyncLogger(sink=got.append)
    log.log("x")
    log.close()
    assert got == ["x"] and log.dropped == 0
    with tprof.device_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
