"""The port's offline job (presets, WAV I/O, limiter, run_offline, run_job)
against the JAX package's, on the CPU; mirrors tests/test_offline_job.py.

Tolerances: presets and WAV bytes exactly; a vocoder-only job at atol 1e-4
(the vocoded leg's bar, tests/test_chain.py); jobs with a resynthesis leg
at max|diff|/peak < 2e-3 (the resynth leg's bar, tests/test_chain.py:83),
the feedback-drone job included.
"""

import json

import numpy as np
import pytest

from cpp_audio_tpu.analysis import autotune as jat
from cpp_audio_tpu.analysis import offline_job as joj
from cpp_audio_tpu.analysis import presets_json as jpj
from cpp_audio_tpu.utils import wav as jwav
from cpp_audio_tpu.utils.midi import Note as JNote
from cpp_audio_tpu_torch.analysis import autotune as tat
from cpp_audio_tpu_torch.analysis import offline_job as toj
from cpp_audio_tpu_torch.analysis import presets_json as tpj
from cpp_audio_tpu_torch.utils import wav as twav
from cpp_audio_tpu_torch.utils.midi import Note as TNote
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 11025
RESYNTH_BAR = 2e-3
VOCODED_BAR = 1e-4


def _voice(seconds=0.6, f=440.0):
    t = np.arange(int(seconds * SR)) / SR
    return 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 1.5 * f * t)


def _square(seconds=0.6, f=110.0):
    t = np.arange(int(seconds * SR)) / SR
    return 0.5 * np.sign(np.sin(2 * np.pi * f * t))


def _presets(**kw):
    base = dict(window_size_seconds=0.05, window_center_stride_seconds=0.025,
                vocoder_modulator_window_size_seconds=0.04, vocoder_stride_seconds=0.01)
    base.update(kw)
    return jpj.ResynthPreset(**base), tpj.ResynthPreset(**base)


class TestPresetJson:
    def test_roundtrip_and_json_equal_to_jax(self, tmp_path):
        p = tpj.ResynthPreset(
            use_autotune=True, autotune_type=tat.AutotuneType.CHORD,
            autotune_musical_scale_root_note=TNote.Mi, vocoder_count_bands=12,
            analysis_volume=0.7, autotune_bit_chord=0b1010)
        j = jpj.ResynthPreset(
            use_autotune=True, autotune_type=jat.AutotuneType.CHORD,
            autotune_musical_scale_root_note=JNote.Mi, vocoder_count_bands=12,
            analysis_volume=0.7, autotune_bit_chord=0b1010)
        assert p.to_json_dict() == j.to_json_dict()
        assert tpj.ResynthPreset().to_json_dict() == jpj.ResynthPreset().to_json_dict()
        f = tmp_path / "p.json"
        p.save(f)
        q = tpj.ResynthPreset.load(f)
        assert q == p
        assert q.autotune_type is tat.AutotuneType.CHORD
        assert q.autotune_musical_scale_root_note is TNote.Mi
        # a preset the JAX package saved loads into the same values
        j.save(tmp_path / "j.json")
        assert tpj.ResynthPreset.load(tmp_path / "j.json").to_json_dict() == j.to_json_dict()

    def test_json_schema_matches_reference(self, tmp_path):
        f = tmp_path / "p.json"
        tpj.ResynthPreset().save(f)
        d = json.loads(f.read_text())
        assert set(d) == {"bool_params", "enum_params", "int32_params",
                          "uint64_params", "float_params"}
        jf = tmp_path / "j.json"
        jpj.ResynthPreset().save(jf)
        assert f.read_text() == jf.read_text()

    def test_job_config_roundtrip(self, tmp_path):
        c = tpj.OfflineJobConfig(preset_file="a.json", input_voice_file="v.wav",
                                 input_carrier_file="c.wav", output_file="o.wav",
                                 post="limit")
        f = tmp_path / "job.json"
        c.save(f)
        assert tpj.OfflineJobConfig.load(f) == c
        assert c.to_json_dict() == jpj.OfflineJobConfig(**vars(c)).to_json_dict()
        # voice-only jobs may omit the carrier and post keys
        (tmp_path / "short.json").write_text(json.dumps(
            {"preset_file": "", "output_file": "o.wav", "postprocessing": "limit"}))
        assert tpj.OfflineJobConfig.load(tmp_path / "short.json").post == "limit"


@pytest.mark.parametrize("bits,fmt", [(16, 1), (24, 1), (32, 1), (32, 3), (64, 3)])
def test_wav_bytes_equal_to_jax(tmp_path, bits, fmt):
    rng = np.random.default_rng(bits + fmt)
    data = np.clip(rng.standard_normal((777, 2)) * 0.4, -1.2, 1.2)
    twav.write_wav(tmp_path / "t.wav", data, SR, bits=bits, fmt=fmt)
    jwav.write_wav(tmp_path / "j.wav", data, SR, bits=bits, fmt=fmt)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = twav.read_wav(tmp_path / "j.wav")
    ref, _ = jwav.read_wav(tmp_path / "j.wav")
    assert sr == SR
    np.testing.assert_array_equal(got, ref)
    with twav.StreamingWavWriter(tmp_path / "s.wav", SR, 2, bits=bits, fmt=fmt) as w:
        w.append(data[:300])
        w.append(data[300:])
    assert (tmp_path / "s.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def _max_rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)


@pytest.mark.parametrize("post", ["none", "limit"])
def test_run_offline_matches_jax(post):
    """All four legs (vocoder, direct voice and carrier, resynthesis)."""
    voice, carrier = _voice(), _square(0.5)
    jp, tp = _presets(analysis_volume=1.0, vocoder_volume=0.8, voice_volume=0.3,
                      carrier_volume=0.2, analysis_input_gain=1.5)
    ref = joj.run_offline(jp, voice, carrier, SR, post=post)
    timings = {}
    got = toj.run_offline(tp, voice, carrier, SR, post=post, device="cpu",
                          timings=timings)
    assert list(timings) == ["to device", "vocoder", "resynthesize", "limiter",
                            "to host"]
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (len(voice), 2)
    assert np.abs(ref).max() > 1e-2
    assert _max_rel(got, ref) < RESYNTH_BAR
    if post == "limit":
        assert np.abs(got).max() <= 1.0 + 1e-9


def test_run_offline_vocoder_leg_matches_jax():
    voice, carrier = _voice(f=300.0), _square()
    jp, tp = _presets(vocoder_volume=1.0, analysis_volume=0.0, carrier_volume=0.0)
    ref = joj.run_offline(jp, voice, carrier, SR)
    got = toj.run_offline(tp, voice, carrier, SR, device="cpu")
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=VOCODED_BAR)


@pytest.mark.parametrize("post", ["none", "limit"])
def test_run_offline_feedback_matches_jax(post):
    """Feedback drones at a 0.15 s delay: ceil(n / D) passes of the batch
    resynthesis on growing prefixes, the delayed mono mix fed back."""
    voice = _voice(0.5)
    jp, tp = _presets(analysis_volume=1.0, analysis_output_feedback_gain=0.5,
                      output_delay_seconds=0.15, voice_volume=0.2)
    ref = joj.run_offline(jp, voice, None, SR, post=post)
    got = toj.run_offline(tp, voice, None, SR, post=post, device="cpu")
    assert got.shape == ref.shape
    assert _max_rel(got, ref) < RESYNTH_BAR


def test_resynthesize_feedback_returns_a_device_tensor_and_zero_gain_is_plain():
    import torch

    from cpp_audio_tpu_torch.analysis import resynth as trs

    voice = _voice(0.4)
    cfg = trs.ResynthConfig(sample_rate=SR, window_size_seconds=0.05,
                            window_center_stride_seconds=0.025)
    plain = trs.resynthesize(voice, cfg, device_out=True, device="cpu")
    fb0 = trs.resynthesize_feedback(voice, cfg, feedback_gain=0.0, device="cpu")
    assert torch.is_tensor(fb0)
    np.testing.assert_array_equal(fb0.numpy(), plain.numpy())


class TestRunJob:
    def test_resynth_job(self, tmp_path):
        twav.write_wav(tmp_path / "voice.wav", _voice(), SR)
        _jp, tp = _presets(analysis_volume=1.0)
        tp.save(tmp_path / "preset.json")
        cfg = tpj.OfflineJobConfig(preset_file=str(tmp_path / "preset.json"),
                                   input_voice_file=str(tmp_path / "voice.wav"),
                                   output_file=str(tmp_path / "out.wav"))
        out = toj.run_job(cfg, device="cpu")
        data, sr = twav.read_wav(tmp_path / "out.wav")
        assert sr == SR and data.shape == out.shape and data.shape[1] == 2
        np.testing.assert_allclose(data, out, atol=2e-7)  # float32 WAV
        assert np.abs(data).max() > 0.01
        jcfg = jpj.OfflineJobConfig(**vars(cfg))
        jcfg.output_file = str(tmp_path / "jax.wav")
        ref = joj.run_job(jcfg)
        assert _max_rel(out, ref) < RESYNTH_BAR

    def test_vocoder_job_file(self, tmp_path):
        twav.write_wav(tmp_path / "voice.wav", _voice(f=300.0), SR)
        twav.write_wav(tmp_path / "carrier.wav", _square(), SR)
        _jp, tp = _presets(vocoder_volume=1.0)
        tp.save(tmp_path / "preset.json")
        tpj.OfflineJobConfig(preset_file=str(tmp_path / "preset.json"),
                             input_voice_file=str(tmp_path / "voice.wav"),
                             input_carrier_file=str(tmp_path / "carrier.wav"),
                             output_file=str(tmp_path / "out.wav"),
                             post="limit").save(tmp_path / "job.json")
        out = toj.run_job_file(tmp_path / "job.json", device="cpu")
        assert 1e-4 < np.abs(out).max() <= 1.0

    def test_missing_inputs_raise(self, tmp_path):
        cfg = tpj.OfflineJobConfig(output_file=str(tmp_path / "o.wav"))
        with pytest.raises(ValueError, match="at least one"):
            toj.run_job(cfg, device="cpu")

    def test_stereo_input_rejected(self, tmp_path):
        twav.write_wav(tmp_path / "st.wav", np.zeros((100, 2)), SR)
        cfg = tpj.OfflineJobConfig(input_voice_file=str(tmp_path / "st.wav"),
                                   output_file=str(tmp_path / "o.wav"))
        with pytest.raises(ValueError, match="single channel"):
            toj.run_job(cfg, device="cpu")

    def test_sample_rate_mismatch_and_no_output_rejected(self, tmp_path):
        twav.write_wav(tmp_path / "v.wav", np.zeros(100), SR)
        twav.write_wav(tmp_path / "c.wav", np.zeros(100), 2 * SR)
        cfg = tpj.OfflineJobConfig(input_voice_file=str(tmp_path / "v.wav"),
                                   input_carrier_file=str(tmp_path / "c.wav"),
                                   output_file=str(tmp_path / "o.wav"))
        with pytest.raises(ValueError, match="sample rate mismatch"):
            toj.run_job(cfg, device="cpu")
        cfg = tpj.OfflineJobConfig(input_voice_file=str(tmp_path / "v.wav"))
        with pytest.raises(ValueError, match="no output file"):
            toj.run_job(cfg, device="cpu")


def test_preset_autosaver_writes_what_jax_writes(tmp_path):
    """PresetAutosaver (host copy): save_once writes the same JSON as the
    JAX package's, only when the preset changed, and restore reads it."""
    _jp, tp = _presets(analysis_volume=0.4)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    saver = tpj.PresetAutosaver(lambda: tp, tdir)
    jsaver = jpj.PresetAutosaver(lambda: _jp, jdir)
    assert saver.restore() is None
    assert saver.save_once() and not saver.save_once() and jsaver.save_once()
    assert (tdir / "autosave.json").read_text() == (jdir / "autosave.json").read_text()
    assert saver.restore() == tp and saver.saves == 1
