"""Command-line apps mirroring the reference's xcode schemes (SURVEY §2.8):
resynth and rt.resynth.job, and the resynth dashboard, on the port's
modules (each takes --device, default cuda)."""
