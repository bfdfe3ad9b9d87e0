"""Training: AdamW, the train step, checkpoints and the Trainer loop."""
