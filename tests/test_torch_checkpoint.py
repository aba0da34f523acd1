"""The port's resumable render-state checkpointing (analysis/checkpoint.py),
on the CPU; mirrors tests/test_checkpoint.py case by case.

The contract: a run interrupted at ANY segment boundary and resumed from
its snapshot produces output bit-identical to an uninterrupted run (held
with assert_array_equal). Against the JAX package's run_offline_streaming
the port is held at max|diff|/peak < 2e-3 (the resynth leg's bar,
tests/test_chain.py:83; LiveResynth renders float32 voices).
"""

import pickle

import numpy as np
import pytest

from cpp_audio_tpu.analysis import checkpoint as jck
from cpp_audio_tpu.analysis import presets_json as jpj
from cpp_audio_tpu_torch.analysis import checkpoint as ckpt
from cpp_audio_tpu_torch.analysis.presets_json import OfflineJobConfig, ResynthPreset
from cpp_audio_tpu_torch.utils import wav as wavio
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 11025
RESYNTH_BAR = 2e-3


def _chirp(seconds, f0=220.0, f1=660.0):
    t = np.arange(int(seconds * SR)) / SR
    f = f0 * (f1 / f0) ** (t / t[-1])
    return (0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR)).astype(np.float64)


_BASE = dict(analysis_volume=1.0, vocoder_volume=0.6, carrier_volume=0.0,
             window_size_seconds=0.05, window_center_stride_seconds=0.025,
             vocoder_modulator_window_size_seconds=0.04,
             vocoder_stride_seconds=0.01)


def _preset(**kw):
    return ResynthPreset(**{**_BASE, **kw})


def _run(preset, voice, carrier, **kw):
    return ckpt.run_offline_streaming(preset, voice, carrier, SR, device="cpu", **kw)


class TestResume:
    def test_uninterrupted_has_no_leftover_checkpoint(self, tmp_path):
        voice = _chirp(1.0)
        path = tmp_path / "ck.bin"
        out = _run(_preset(), voice, voice, checkpoint_path=path, segment_seconds=0.3)
        assert isinstance(out, np.ndarray) and out.shape == (len(voice), 2)
        assert np.max(np.abs(out)) > 0
        assert not path.exists()

    @pytest.mark.parametrize("kill_after", [1, 2, 3])
    def test_resume_bit_identical(self, tmp_path, kill_after):
        voice = _chirp(1.4)
        preset = _preset()
        full = _run(preset, voice, voice, segment_seconds=0.3)
        path = tmp_path / "ck.bin"
        # simulated kill after `kill_after` segments...
        assert _run(preset, voice, voice, checkpoint_path=path, segment_seconds=0.3,
                    max_segments=kill_after) is None
        assert path.exists()
        # ...then resume to completion
        resumed = _run(preset, voice, voice, checkpoint_path=path, segment_seconds=0.3)
        np.testing.assert_array_equal(resumed, full)
        assert not path.exists()

    def test_resume_bit_identical_with_feedback_and_limit(self, tmp_path):
        voice = _chirp(1.2)
        preset = _preset(vocoder_volume=0.0, analysis_output_feedback_gain=0.5,
                         output_delay_seconds=0.15)
        full = _run(preset, voice, None, post="limit", segment_seconds=0.25)
        path = tmp_path / "ck.bin"
        assert _run(preset, voice, None, post="limit", checkpoint_path=path,
                    segment_seconds=0.25, max_segments=2) is None
        resumed = _run(preset, voice, None, post="limit", checkpoint_path=path,
                       segment_seconds=0.25)
        np.testing.assert_array_equal(resumed, full)
        assert np.abs(full).max() <= 1.0 + 1e-9

    def test_stale_checkpoint_restarts_from_scratch(self, tmp_path):
        voice = _chirp(1.0)
        path = tmp_path / "ck.bin"
        assert _run(_preset(analysis_input_gain=0.5), voice, voice, checkpoint_path=path,
                    segment_seconds=0.3, max_segments=1) is None
        assert path.exists()
        preset = _preset()
        out = _run(preset, voice, voice, checkpoint_path=path, segment_seconds=0.3)
        full = _run(preset, voice, voice, segment_seconds=0.3)
        np.testing.assert_array_equal(out, full)

    def test_corrupt_checkpoint_ignored(self, tmp_path):
        path = tmp_path / "ck.bin"
        path.write_bytes(b"not a pickle")
        assert ckpt.load_checkpoint(path, "whatever") is None
        assert ckpt.load_checkpoint(tmp_path / "absent.bin", "x") is None
        path.write_bytes(pickle.dumps({"not": "a state"}))
        assert ckpt.load_checkpoint(path, "whatever") is None
        # the right header over a payload that does not unpickle
        path.write_bytes(f"{ckpt._MAGIC}\nwhatever\n".encode() + b"garbage")
        assert ckpt.load_checkpoint(path, "whatever") is None

    def test_same_length_different_content_restarts(self, tmp_path):
        v1 = _chirp(1.0)
        v2 = _chirp(1.0, f0=330.0, f1=990.0)
        preset = _preset(vocoder_volume=0.0)
        path = tmp_path / "ck.bin"
        assert _run(preset, v1, None, checkpoint_path=path, segment_seconds=0.3,
                    max_segments=1) is None
        out = _run(preset, v2, None, checkpoint_path=path, segment_seconds=0.3)
        full = _run(preset, v2, None, segment_seconds=0.3)
        np.testing.assert_array_equal(out, full)

    def test_mismatched_input_lengths(self, tmp_path):
        voice = _chirp(0.8)
        carrier = _chirp(1.2)
        preset = _preset()
        full = _run(preset, voice, carrier, segment_seconds=0.25)
        assert full.shape == (len(carrier), 2)
        path = tmp_path / "ck.bin"
        assert _run(preset, voice, carrier, checkpoint_path=path, segment_seconds=0.25,
                    max_segments=2) is None
        resumed = _run(preset, voice, carrier, checkpoint_path=path, segment_seconds=0.25)
        np.testing.assert_array_equal(resumed, full)
        out2 = _run(preset, carrier, voice, segment_seconds=0.25)
        assert out2.shape == (len(carrier), 2)

    def test_snapshot_size_tracks_progress(self, tmp_path):
        voice = _chirp(2.0)
        preset = _preset(vocoder_volume=0.0)
        p1, p2 = tmp_path / "early.bin", tmp_path / "late.bin"
        _run(preset, voice, None, checkpoint_path=p1, segment_seconds=0.25, max_segments=1)
        _run(preset, voice, None, checkpoint_path=p2, segment_seconds=0.25, max_segments=7)
        assert p1.stat().st_size < p2.stat().st_size * 0.5


class TestAgainstJax:
    @pytest.mark.parametrize("case", ["vocoder", "feedback_limit"])
    def test_streaming_output_matches_jax(self, case):
        if case == "vocoder":
            voice, carrier, post = _chirp(1.0), _chirp(1.0, 110.0, 220.0), "none"
            kw = dict(voice_volume=0.2, carrier_volume=0.1)
        else:
            voice, carrier, post = _chirp(1.0), None, "limit"
            kw = dict(vocoder_volume=0.0, analysis_output_feedback_gain=0.5,
                      output_delay_seconds=0.15)
        ref = jck.run_offline_streaming(jpj.ResynthPreset(**{**_BASE, **kw}), voice,
                                        carrier, SR, post=post, segment_seconds=0.3)
        got = _run(_preset(**kw), voice, carrier, post=post, segment_seconds=0.3)
        assert got.shape == ref.shape and np.abs(ref).max() > 1e-2
        assert float(np.abs(got - ref).max()) / float(np.abs(ref).max()) < RESYNTH_BAR

    def test_a_jax_snapshot_is_not_resumed(self, tmp_path):
        """A snapshot the JAX package wrote at the same path, for the same
        job, is neither unpickled nor resumed: the port restarts and
        matches its own uninterrupted run."""
        voice = _chirp(1.0)
        path = tmp_path / "ck.bin"
        assert jck.run_offline_streaming(jpj.ResynthPreset(**_BASE), voice, voice, SR,
                                         checkpoint_path=path, segment_seconds=0.3,
                                         max_segments=2) is None
        assert path.exists()
        fp = ckpt._fingerprint(_preset(), voice, voice, SR, "none", 512, 4.0, "cpu")
        assert ckpt.load_checkpoint(path, fp, len(voice), device="cpu") is None
        out = _run(_preset(), voice, voice, checkpoint_path=path, segment_seconds=0.3)
        np.testing.assert_array_equal(out, _run(_preset(), voice, voice,
                                                segment_seconds=0.3))

    def test_snapshot_holds_host_arrays_only(self, tmp_path):
        """The pickled pipeline state carries no torch storage: its tensors
        are host arrays, restored onto the pipeline's device on load."""
        import torch

        voice = _chirp(1.0)
        path = tmp_path / "ck.bin"
        assert _run(_preset(), voice, voice, checkpoint_path=path, segment_seconds=0.3,
                    max_segments=1) is None
        assert b"torch._utils" not in path.read_bytes()
        fp = ckpt._fingerprint(_preset(), voice, voice, SR, "none", 512, 4.0, "cpu")
        state = ckpt.load_checkpoint(path, fp, len(voice), device="cpu")
        assert state is not None and state.pos > 0
        assert torch.is_tensor(state.out) and state.out.shape == (len(voice), 2)
        assert torch.is_tensor(state.svoc._amps) and state.svoc._amps.device.type == "cpu"
        assert torch.is_tensor(state.live._window)
        # another device type is another fingerprint: never resumed there
        assert fp != ckpt._fingerprint(_preset(), voice, voice, SR, "none", 512, 4.0,
                                       "cuda")


class TestJob:
    def test_run_job_checkpointed(self, tmp_path):
        voice = _chirp(0.8)
        vf = tmp_path / "v.wav"
        wavio.write_wav(vf, voice[:, None], SR, bits=32, fmt=wavio.WAVE_FORMAT_IEEE_FLOAT)
        pf = tmp_path / "p.json"
        _preset(vocoder_volume=0.0).save(pf)
        cfg = OfflineJobConfig(preset_file=str(pf), input_voice_file=str(vf),
                               output_file=str(tmp_path / "o.wav"), post="limit")
        # a simulated kill writes no WAV; the resumed run does
        assert ckpt.run_job_checkpointed(cfg, tmp_path / "ck.bin", segment_seconds=0.25,
                                         max_segments=1, device="cpu") is None
        assert not (tmp_path / "o.wav").exists()
        out = ckpt.run_job_checkpointed(cfg, tmp_path / "ck.bin", segment_seconds=0.25,
                                        device="cpu")
        data, sr = wavio.read_wav(tmp_path / "o.wav")
        assert sr == SR
        np.testing.assert_allclose(data, out, atol=2e-7)

    def test_cli_checkpoint_flag(self, tmp_path):
        from cpp_audio_tpu_torch.apps import resynth as app

        voice = _chirp(0.6)
        vf = tmp_path / "v.wav"
        wavio.write_wav(vf, voice[:, None], SR, bits=32, fmt=wavio.WAVE_FORMAT_IEEE_FLOAT)
        pf = tmp_path / "p.json"
        _preset(vocoder_volume=0.0).save(pf)
        jf = tmp_path / "job.json"
        OfflineJobConfig(preset_file=str(pf), input_voice_file=str(vf),
                         output_file=str(tmp_path / "o.wav")).save(jf)
        assert app.main(["--job", str(jf), "--checkpoint", str(tmp_path / "ck.bin"),
                         "--checkpoint-seconds", "0.25", "--device", "cpu"]) == 0
        data, sr = wavio.read_wav(tmp_path / "o.wav")
        assert sr == SR and len(data) == len(voice)

    def test_cli_checkpoint_requires_job(self):
        from cpp_audio_tpu_torch.apps import resynth as app

        with pytest.raises(SystemExit):
            app.main(["in.wav", "out.wav", "--checkpoint", "ck.bin", "--device", "cpu"])

    def test_cli_carrier_spec_validation(self):
        from cpp_audio_tpu_torch.apps import resynth as app

        with pytest.raises(ValueError):
            app._parse_kv("saw", app._CARRIER_KEYS)
        with pytest.raises(ValueError):
            app._parse_kv("sqare=1", app._CARRIER_KEYS)
        with pytest.raises(ValueError):
            app._parse_kv("saw=x", app._CARRIER_KEYS)
        assert app._parse_kv("saw=0.5, width=0.01", app._CARRIER_KEYS) == {
            "saw": 0.5, "width": 0.01}
