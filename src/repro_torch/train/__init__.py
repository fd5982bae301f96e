"""Training substrate of the port: AdamW, checkpoints and the
fault-tolerant loop."""
