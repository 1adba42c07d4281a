"""Training: AdamW, the train step, checkpoints and the data pipeline."""
