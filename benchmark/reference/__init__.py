"""The benchmark's plain reference: frozen float64 oracles, their batched
PyTorch form, and a plain PCM16 WAV codec.  Imports nothing of the program."""
