"""The plain reference: fp32 PyTorch with TF32 off, written from the
published description of F5-TTS (DiT, UNetT), Vocos, the log-mel, the CFM
sampler and loss, and AdamW.  It imports nothing of the program."""
