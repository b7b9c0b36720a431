"""The plain reference that decides ``correct``: plain PyTorch, float32
with TF32 off.  It imports nothing of ``jax``, ``repro`` or
``repro_torch``, and works out again whatever the program derives from
the benchmark's inputs (transition-time law, draws, tokens)."""
