"""Training: AdamW and checkpoints (ports of ``repro/train``)."""
