"""Training: optimizers, the train step, and the train step as a
placement-priced pipeline op (the JAX package's ``train/`` in PyTorch)."""
