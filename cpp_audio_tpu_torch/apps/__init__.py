"""Command-line apps mirroring the reference's xcode schemes (SURVEY §2.8):
resynth and rt.resynth.job, the resynth dashboard, tune, test_fft and the
WAV tools, on the port's modules (each device app takes --device, default
cuda)."""
