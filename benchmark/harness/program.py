"""The program under test, cpp_audio_tpu_torch, as the cells call it.

A job's voices go in as the program's VoiceBank; its outputs come back as
host arrays. The analysis peaks that enter the program's tracker are kept
by reference (no copy, no added device work) so that the check can read the
sampled jobs' peaks once the window has closed. The chain returns no peaks,
so they are taken where it hands them to device_tracker.build_tables_device
(or _batch); a job during which that call did not run exactly once raises,
rather than leave the check stale or empty peaks.
"""

from __future__ import annotations

import numpy as np


def program_configs(config: dict):
    """The program's ResynthConfig and VocoderParams of a configuration,
    checked against the window and strides the configuration states."""
    from cpp_audio_tpu_torch.analysis import resynth, vocoder

    tr, vc = config["tracker"], config["vocoder"]
    rconfig = resynth.ResynthConfig(
        sample_rate=config["sample_rate"], window_size_seconds=config["window_seconds"],
        window_center_stride_seconds=config["stride_seconds"],
        min_volume=tr["min_volume"], nearby_distance_tones=tr["nearby_distance_tones"],
        max_track_pitches=tr["max_track_pitches"], stereo_spread=tr["stereo_spread"],
        analysis_volume=tr["analysis_volume"], max_voices=config["max_voices"],
        dtype=config["dtype"], seed=tr["pan_seed"])
    vparams = vocoder.VocoderParams(
        sample_rate=config["sample_rate"], stride_seconds=vc["stride_seconds"],
        modulator_window_size_seconds=vc["window_seconds"], count_bands=vc["bands"],
        min_freq=vc["min_hz"], max_freq=vc["max_hz"], volume_vocoded=vc["vol_voc"],
        volume_modulator=vc["vol_mod"], volume_carrier=vc["vol_car"])
    derived = (rconfig.window_size, rconfig.stride, vparams.stride, vparams.modulator_window)
    stated = (config["window"], config["stride"], vc["stride"], vc["window"])
    if derived != stated:
        raise SystemExit(f"the program derives window, stride, vocoder stride and window "
                         f"{derived}, the configuration states {stated}")
    return rconfig, vparams


class Program:
    def __init__(self, config: dict, device: str = "cuda"):
        from cpp_audio_tpu_torch.analysis import chain, device_tracker
        from cpp_audio_tpu_torch.models.voicebank import VoiceBank

        self.chain, self.VoiceBank, self.device = chain, VoiceBank, device
        self.tracker = device_tracker
        self.rconfig, self.vparams = program_configs(config)
        self.block_size = config["synth"]["block_size"]
        self.peaks = None  # (freq, mag) entering the tracker's latest call
        self.tracker_calls = 0
        for name in ("build_tables_device", "build_tables_device_batch"):
            self._keep_peaks(device_tracker, name)

    def _keep_peaks(self, module, name: str) -> None:
        build = getattr(module, name)

        def keeping(freq, mag, *args, **kw):
            self.peaks = (freq, mag)
            self.tracker_calls += 1
            return build(freq, mag, *args, **kw)

        setattr(module, name, keeping)

    def _peaks_of(self, calls_before: int):
        if self.tracker_calls != calls_before + 1:
            raise RuntimeError(
                f"the device tracker's entry ran {self.tracker_calls - calls_before} times in "
                "one job or batch, not once: the check cannot read the job's analysis peaks")
        return self.peaks

    def frame_loops(self) -> int:
        """Jobs the device tracker has sent down its exact frame loop."""
        return self.tracker.FRAME_LOOPS

    def bank(self, voices: dict):
        return self.VoiceBank(**voices)

    def run_job(self, job: dict, timings: dict | None = None) -> dict:
        """run_offline_chain_device on one job -> host outputs."""
        calls = self.tracker_calls
        r = self.chain.run_offline_chain_device(
            self.bank(job["voices"]), job["n"], self.rconfig, self.vparams, job["carrier"],
            block_size=self.block_size, device=self.device, timings=timings)
        return dict(stereo=r.resynth.cpu().numpy(), vocoded=r.vocoded.cpu().numpy(),
                    dropped=int(r.dropped), peaks=self._peaks_of(calls), row=None)

    def prepare_batch(self, jobs: list[dict]):
        step, _n_frames = self.chain.prepare_offline_chain_device_batch(
            [self.bank(j["voices"]) for j in jobs], jobs[0]["n"], self.rconfig,
            self.vparams, jobs[0]["carrier"], block_size=self.block_size,
            device=self.device)
        return step

    def finish_batch(self, step, jobs: list[dict]) -> list[dict]:
        """step() -> each job's host outputs."""
        calls = self.tracker_calls
        stereo, vocoded, dropped = step()
        stereo, vocoded = stereo.cpu().numpy(), vocoded.cpu().numpy()
        dropped = dropped.cpu().numpy()
        peaks = self._peaks_of(calls)
        return [dict(stereo=stereo[b], vocoded=vocoded[b], dropped=int(dropped[b]),
                     peaks=peaks, row=b) for b in range(len(jobs))]

    def run_batch(self, jobs: list[dict]) -> list[dict]:
        return self.finish_batch(self.prepare_batch(jobs), jobs)


def host_peaks(out: dict) -> tuple[np.ndarray, np.ndarray]:
    """A kept job's tracker-input peaks as host (frames, k) arrays."""
    freq, mag = out["peaks"]
    if out["row"] is not None:
        freq, mag = freq[out["row"]], mag[out["row"]]
    return freq.cpu().numpy(), mag.cpu().numpy()
