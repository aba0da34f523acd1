"""Plain reference of the offline resynthesis chain, for the benchmark's
`correct`: plain PyTorch and numpy, independent of the program under test.

It imports nothing of `cpp_audio_tpu_torch`, of JAX or of the JAX package,
and takes none of the program's tables: it works from the voice-bank fields
and the carrier that the benchmark made for a job. The one state of the
program it reads is the analysis peaks that enter the program's tracker (see
`chain.py`), and `chain.py` checks those against its own peaks first.
"""
