"""core layer of the PyTorch port (mirrors cpp_audio_tpu/core)."""
